"""The port's scheduled fault injection ("chaos") against the JAX package's.

The schedule compiler is a copy of the JAX module's numpy code: one config
compiles to equal tables in both. The engines then run the same
configuration from the same state under the JAX draw oracle
(``tests/torch_oracle.py``), which replays the peer draw over the round's
alive edges, the spiked drop rate and the scaled delays under the JAX
engine's purpose tags. Each fault kind (partition, outage, churn, a drop
spike, a delay spike) is held on a deliver path: the accounting exactly,
the fourth failure cause ``failed_chaos`` included, the probe, sentinel
and chaos arrays within 1e-5 of the value plus 1e-6
(``torch_pairs.assert_same_telemetry``), and ``rounds_to_reconverge``
equal. All2All's partition gap and the token simulator's reactions under
chaos are held the same way; PENS refuses edge faults as the JAX simulator
does; the sparse topology's CSR and slot mask forms equal the JAX
package's.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_pairs as tp
from gossipy_tpu import core as jcore
from gossipy_tpu.handlers import SGDHandler, losses
from gossipy_tpu.models import LogisticRegression
from gossipy_tpu.simulation import faults as jfaults
from gossipy_tpu_torch import core as tcore
from gossipy_tpu_torch import handlers as th
from gossipy_tpu_torch.core import UniformDelay
from gossipy_tpu_torch.flow_control import SimpleTokenAccount
from gossipy_tpu_torch.models import LogisticRegression as TLogReg
from gossipy_tpu_torch.random import TorchDraws
from gossipy_tpu_torch.simulation import GossipSimulator, \
    PENSGossipSimulator
from gossipy_tpu_torch.simulation.faults import ChaosConfig, ChurnProcess, \
    FaultSpike, OutageEpisode, PartitionEpisode, build_fault_schedule, \
    rounds_to_reconverge

N = tp.N
HALF = (tuple(range(N // 2)), tuple(range(N // 2, N)))
ROUNDS = 8
SCENARIOS = {
    "partition": ChaosConfig(partitions=(
        PartitionEpisode(components=HALF, start=2, stop=5),)),
    "outage": ChaosConfig(outages=(
        OutageEpisode(nodes=(0, 3, 7), start=1, stop=4),
        OutageEpisode(nodes=(5,), start=3, stop=6))),
    "churn": ChaosConfig(churn=ChurnProcess(keep_frac=0.5, start=1, stop=7,
                                            period=2, seed=3)),
    "drop_spike": ChaosConfig(spikes=(
        FaultSpike(start=2, stop=5, drop_prob=0.6),)),
    "delay_spike": ChaosConfig(spikes=(
        FaultSpike(start=1, stop=4, delay_scale=2.5),), horizon=6),
}


def regular():
    return tcore.Topology.random_regular(N, 4, seed=5)


def test_fault_schedule_equals_jax():
    """One config with every kind of episode compiles to equal tables in
    both packages (churn draws from ``default_rng((seed, epoch))``)."""
    cfg = ChaosConfig(
        outages=(OutageEpisode(nodes=(1, 2), start=0, stop=3),),
        partitions=(PartitionEpisode(components=((0, 1, 2), (3, 4)),
                                     start=2, stop=6),),
        churn=ChurnProcess(keep_frac=0.7, start=1, stop=9, period=3, seed=11),
        spikes=(FaultSpike(start=4, stop=7, drop_prob=0.3, delay_scale=2.0),),
        horizon=10)
    topo = regular()
    got = build_fault_schedule(cfg, topo, 0.05)
    want = jfaults.build_fault_schedule(
        jfaults.ChaosConfig.from_dict(cfg.to_dict()),
        jcore.Topology(topo.adjacency), 0.05)
    for f in ("forced_offline", "drop_prob", "delay_scale", "mask_idx",
              "component_id", "edge_masks"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.rows == want.rows == 11
    assert cfg.to_dict() == jfaults.ChaosConfig.from_dict(
        cfg.to_dict()).to_dict()


@pytest.mark.parametrize("kind,path,delay", [
    ("partition", "multi", None),
    ("outage", "plain-compact", None),
    ("churn", "multi-compact", None),
    ("drop_spike", "per_slot", None),
    ("delay_spike", "plain", UniformDelay(0, 90)),
])
def test_chaos_kind_matches_jax(kind, path, delay):
    """Each fault kind on a deliver path, with probes and sentinels on:
    the run, ``failed_chaos`` and every telemetry array equal the JAX
    engine's."""
    key = jax.random.PRNGKey(10)
    fused, cap = tp.PATHS[path]
    topo = regular()
    data = tp.small_data()
    kw = dict(fused_merge=fused, compact_deliver=cap, probes=True,
              sentinels=True, chaos=SCENARIOS[kind], drop_prob=0.1,
              online_prob=0.9)
    if delay is not None:
        kw["delay"] = delay
    jsim, tsim = tp.make_pair(jcore.Topology(topo.adjacency), topo, data,
                              data, key, **kw)
    jst = jsim.init_nodes(key, common_init=True)
    tst = tp.to_port_state(tsim, jst)
    assert tsim._history_depth(1) == jsim._history_depth(1)
    jst, jrep = jsim.start(jst, n_rounds=ROUNDS, key=key, donate_state=False)
    tst, trep = tsim.start(tst, n_rounds=ROUNDS)
    tp.assert_same_run(jsim, tsim, jst, tst, jrep, trep)
    tp.assert_same_telemetry(jrep, trep)
    causes = trep.failed_per_cause
    assert sorted(causes) == ["chaos", "drop", "offline", "overflow"]
    np.testing.assert_array_equal(
        sum(causes[c] for c in causes), trep.failed_per_round)
    if kind == "outage":
        assert causes["chaos"].sum() > 0
    if kind == "partition":
        gap = trep.chaos_component_gap
        assert gap[2:5].max() > 0
        np.testing.assert_array_equal(trep.chaos_active_components,
                                      [1, 1] + [2] * (ROUNDS - 2))


def lr0_handlers():
    """LogReg under SGD 0 (no local learning: pure averaging) in both
    packages."""
    jh = SGDHandler(model=LogisticRegression(tp.D_FEAT, 2),
                    loss=losses.cross_entropy, optimizer=optax.sgd(0.0),
                    local_epochs=1, batch_size=8, n_classes=2,
                    input_shape=(tp.D_FEAT,))
    thd = th.SGDHandler(TLogReg(tp.D_FEAT, 2), th.losses.cross_entropy,
                        learning_rate=0.0, local_epochs=1, batch_size=8,
                        n_classes=2, input_shape=(tp.D_FEAT,))
    return jh, thd


def two_blocks(jst, tst, tsim):
    """Nodes of the first half carry the constant 1, the others 3, in
    both states."""
    vals = jnp.where(jnp.arange(N) < N // 2, 1.0, 3.0)
    params = jax.tree.map(lambda l: jnp.broadcast_to(
        vals.reshape((N,) + (1,) * (l.ndim - 1)), l.shape).astype(l.dtype),
        jst.model.params)
    jst = jst._replace(model=jst.model._replace(params=params))
    width = tsim.handler.layout.width
    p = torch.zeros_like(tst.model.params)
    p[:, :width] = torch.where(torch.arange(N) < N // 2, 1.0, 3.0)[:, None]
    tst.model = tst.model._replace(params=p)
    return jst, tst


def test_partition_reconverges_as_in_jax():
    """Pure averaging from two constant blocks: the gap between the halves
    holds while the partition does, closes after the heal, and
    ``rounds_to_reconverge`` is the JAX run's."""
    key = jax.random.PRNGKey(11)
    cfg = ChaosConfig(partitions=(
        PartitionEpisode(components=HALF, start=0, stop=4),), horizon=12)
    jsim, tsim = tp.make("GossipSimulator", lr0_handlers(), regular(),
                         tp.small_data(), key, fused_merge="multi",
                         chaos=cfg, probes=True)
    jst = jsim.init_nodes(key, common_init=True)
    tst = tp.to_port_state(tsim, jst)
    jst, tst = two_blocks(jst, tst, tsim)
    jst, jrep = jsim.start(jst, n_rounds=12, key=key, donate_state=False)
    tst, trep = tsim.start(tst, n_rounds=12)
    tp.assert_same_run(jsim, tsim, jst, tst, jrep, trep)
    tp.assert_same_telemetry(jrep, trep)
    gap = trep.chaos_component_gap
    assert gap[:4].min() > 1.0        # the halves stay apart
    jgap = jrep.chaos_component_gap
    assert rounds_to_reconverge(gap, 4) == \
        jfaults.rounds_to_reconverge(jgap, 4)
    tol = 0.1 * float(gap[:4].max())
    got = rounds_to_reconverge(gap, 4, tol)
    assert got == jfaults.rounds_to_reconverge(jgap, 4, tol)
    assert got is not None and got > 0


def test_all2all_partition_gap_matches_jax():
    """All2All's broadcast mixing under a partition and an outage: the
    masked edges, ``failed_chaos`` and the component gap as the JAX
    simulator's."""
    key = jax.random.PRNGKey(12)
    cfg = ChaosConfig(
        partitions=(PartitionEpisode(components=HALF, start=1, stop=4),),
        outages=(OutageEpisode(nodes=(2,), start=2, stop=5),))
    jsim, tsim = tp.make("All2AllGossipSimulator", tp.logreg("weighted"),
                         regular(), tp.small_data(), key,
                         mixing="uniform_mixing", drop_prob=0.1,
                         chaos=cfg, probes=True, sentinels=True)
    jst = jsim.init_nodes(key, common_init=True)
    tst = tp.to_port_state(tsim, jst)
    jst, jrep = jsim.start(jst, n_rounds=6, key=key, donate_state=False)
    tst, trep = tsim.start(tst, n_rounds=6)
    tp.assert_same_run(jsim, tsim, jst, tst, jrep, trep)
    tp.assert_same_telemetry(jrep, trep)
    assert trep.failed_per_cause["chaos"].sum() > 0
    assert trep.chaos_component_gap[1:4].max() > 0


def test_token_reactions_under_chaos_match_jax():
    """The token simulator's reaction waves under an outage, a partition
    and a drop spike: forced-offline nodes do not react, the reaction
    peers are drawn over the alive edges, and the run and telemetry
    equal the JAX simulator's."""
    key = jax.random.PRNGKey(13)
    cfg = ChaosConfig(
        outages=(OutageEpisode(nodes=(1, 4), start=1, stop=5),),
        partitions=(PartitionEpisode(components=HALF, start=2, stop=6),),
        spikes=(FaultSpike(start=3, stop=5, drop_prob=0.5),))
    jsim, tsim = tp.make("TokenizedGossipSimulator", tp.logreg(), regular(),
                         tp.small_data(), key, fused_merge="per_slot",
                         token_account=SimpleTokenAccount(C=1),
                         chaos=cfg, probes=True, sentinels=True)
    jst = jsim.init_nodes(key, common_init=True)
    tst = tp.to_port_state(tsim, jst)
    jst, jrep = jsim.start(jst, n_rounds=7, key=key, donate_state=False)
    tst, trep = tsim.start(tst, n_rounds=7)
    tp.assert_same_run(jsim, tsim, jst, tst, jrep, trep)
    tp.assert_same_aux(tsim, jst, tst)
    tp.assert_same_telemetry(jrep, trep)


def test_pens_refuses_edge_faults():
    """PENS draws its own peers: partitions and churn would bypass it, so
    the constructor refuses them, as the JAX simulator does; outages and
    spikes are taken."""
    jh, thd = tp.logreg()
    data = tp.small_data()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ValueError, match="_select_peers"):
            PENSGossipSimulator(thd, regular(), data, n_sampled=2, m_top=1,
                                chaos=SCENARIOS["partition"], device="cpu")
        sim = PENSGossipSimulator(thd, regular(), data, n_sampled=2,
                                  m_top=1, chaos=SCENARIOS["outage"],
                                  device="cpu")
    assert sim.chaos_schedule is not None


def test_masked_peer_draws_are_cached_per_mask():
    """One masked adjacency per distinct schedule mask, made once, and
    one set of neighbour lists per adjacency in the draw provider; a node
    whose every edge is dead gets peer -1; rounds past the horizon read
    the baseline row."""
    topo = tcore.Topology.ring(N, 1)
    # Node 0's two neighbours (1 and N - 1) sit in the other component.
    cfg = ChaosConfig(
        partitions=(PartitionEpisode(components=((0,), tuple(range(1, N))),
                                     start=1, stop=3),),
        churn=ChurnProcess(keep_frac=0.6, start=4, stop=8, period=2, seed=1))
    sim = GossipSimulator(tp.handlers(tp.D_FEAT, 8)[1], topo,
                          tp.small_data(), chaos=cfg, fused_merge="multi",
                          draws=TorchDraws(0), device="cpu")
    st = sim.init_nodes(torch.Generator().manual_seed(0))
    sim.start(st, n_rounds=10)
    used = set(int(m) for m in sim.chaos_schedule.mask_idx[:10])
    assert set(sim._chaos_adjs) == used | {0}
    assert len(sim.draws._neighbours) == len(used | {0})
    assert all(sim.draws._neighbours[id(a)][0] is a
               for a in sim._chaos_adjs.values())
    assert int(sim._chaos_masked_peers(1)[0]) == -1
    assert int(sim._chaos_masked_peers(3)[0]) >= 0
    assert sim._chaos_t(500) == sim.chaos_schedule.rows - 1
    assert not sim._chaos_forced_offline(500).any()


def test_sparse_forms_raise():
    """Over a sparse topology the schedule's CSR and slot forms equal the
    JAX package's (the canonical pair order is the same for dense and
    CSR, so the churn draws land on the same edges); edge faults over a
    topology with neither a CSR nor a dense adjacency raise."""
    jtopo = jcore.SparseTopology.random_regular(48, 4, seed=5)
    topo = tcore.SparseTopology.random_regular(48, 4, seed=5)
    cfg = ChaosConfig(
        partitions=(PartitionEpisode(components=(tuple(range(20)),),
                                     start=1, stop=4),),
        churn=ChurnProcess(keep_frac=0.6, start=2, stop=8, period=2,
                           seed=4), horizon=9)
    got = build_fault_schedule(cfg, topo, 0.1)
    want = jfaults.build_fault_schedule(
        jfaults.ChaosConfig.from_dict(cfg.to_dict()), jtopo, 0.1)
    for f in ("mask_idx", "component_id", "csr_masks", "slot_masks"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.edge_masks == () and got.csr_masks.shape[1] == 48 * 4
    # The CSR masks are the dense masks read along the CSR edges.
    dense = build_fault_schedule(cfg, topo.to_dense(), 0.1)
    rows = np.repeat(np.arange(48), topo.degrees)
    np.testing.assert_array_equal(
        got.csr_masks, dense.edge_masks[:, rows, topo.indices])

    class Neither:
        num_nodes = N
        adjacency = None

    with pytest.raises(TypeError):
        build_fault_schedule(SCENARIOS["partition"], Neither(), 0.0)
    # Node faults alone need no edge table.
    sched = build_fault_schedule(SCENARIOS["outage"], Neither(), 0.0)
    assert sched.edge_masks == () and sched.slot_masks == ()
