"""The simulator variants and the scale twin over sparse topologies,
against the JAX package under the draw oracle: pass-through nodes, the
neighbour cache, PENS (its fallback peer the CSR draw) and the token
simulator's reaction peers; All2All over ``SparseMixing`` in its padded
and segment forms, with uniform and Metropolis-Hastings weights, with and
without chaos; the port's sparse All2All against its dense one; and
``gossipy_tpu_torch/examples/scale.py`` at 64 nodes against the JAX scale
row's configuration.

Each port run is held against the JAX run of the same configuration as
``torch_pairs.check_variant`` holds it: accounting and both boxes
exactly, ages and ``aux`` equal, params within 1e-5 (PERF.md section 2).
"""

import warnings

import jax
import numpy as np
import optax
import pytest
import torch

import torch_pairs as tp
from gossipy_tpu import core as jcore
from gossipy_tpu.core import AntiEntropyProtocol, CreateModelMode
from gossipy_tpu.data import ClassificationDataHandler, DataDispatcher
from gossipy_tpu.handlers import SGDHandler, WeightedSGDHandler, losses
from gossipy_tpu.models import LogisticRegression
from gossipy_tpu.simulation import All2AllGossipSimulator as JAll2All
from gossipy_tpu.simulation import GossipSimulator as JGossipSimulator
from gossipy_tpu_torch import core as tcore
from gossipy_tpu_torch import flow_control as tflow
from gossipy_tpu_torch import simulation as tsimulation
from gossipy_tpu_torch.examples import scale
from gossipy_tpu_torch.simulation.faults import ChaosConfig, ChurnProcess, \
    PartitionEpisode
from torch_oracle import JaxDraws
from torch_pairs import PEGASOS_RTOL, check_variant, logreg, make, pegasos

torch.set_num_threads(1)

N = 48


def ba():
    return tcore.SparseTopology.barabasi_albert(N, 3, seed=2)


def regular(n=N, d=4):
    return tcore.SparseTopology.random_regular(n, d, seed=5)


def data(n=N, signed=False):
    return tp.small_data(signed=signed, n=n)


# -- the node behaviours and the token simulator ------------------------------

def passthrough(key, **kw):
    kw = {"fused_merge": False, **kw}
    return make("PassThroughGossipSimulator", pegasos(), ba(),
                data(signed=True), key, sync=False,
                delay=tcore.UniformDelay(0, 150), **kw)


def cacheneigh(key, **kw):
    return make("CacheNeighGossipSimulator", pegasos(), ba(),
                data(signed=True), key, sync=False, **kw)


def pens(key, **kw):
    return make("PENSGossipSimulator", logreg(), regular(12, 4),
                data(12), key, sync=False, n_sampled=3, m_top=2,
                step1_rounds=3, **kw)


def tokenized(key, **kw):
    kw = {"fused_merge": False, **kw}
    return make("TokenizedGossipSimulator", logreg(), regular(), data(), key,
                token_account=tflow.RandomizedTokenAccount(C=3, A=1),
                max_reactions=2, delay=tcore.UniformDelay(0, 150),
                sync=True, **kw)


@pytest.mark.parametrize("cap", [False, 8])
def test_sparse_passthrough_matches_jax(cap):
    """Pass-through nodes on a sparse hub graph: the payload is the
    sender's CSR degree; the wide pass, and the compacted one."""
    tsim, tst, trep = check_variant(passthrough, 31, 6, common_init=False,
                                    rtol=PEGASOS_RTOL, compact_deliver=cap)
    snd, ext = tst.mailbox.sender, tst.mailbox.extra
    live = snd >= 0
    assert live.any()
    deg = torch.as_tensor(tsim.topology.degrees)
    assert torch.equal(ext[live], deg[snd[live].long()].to(ext.dtype))
    assert (trep.compact_slots_per_round.sum() > 0) == bool(cap)


def test_sparse_cacheneigh_matches_jax():
    tsim, tst, _ = check_variant(cacheneigh, 32, 6, common_init=False,
                                 rtol=PEGASOS_RTOL)
    assert tst.aux["cache_valid"].any()
    assert tsim.nbr_table.shape == (N, int(tsim.topology.degrees.max()))


def test_sparse_pens_matches_jax_across_the_phase_switch():
    """PENS on a sparse regular graph: phase 1 draws into the CSR rows,
    phase 2 picks among the best neighbours and falls back to the CSR
    draw under ``fold_in(key, 3)`` where a node has none."""
    tsim, tst, trep = check_variant(pens, 34, 7)
    best = tst.aux["best"]
    assert best.any() and tst.aux["neigh_counter"].sum() > 0
    assert len(trep.sent_per_round) == 7


@pytest.mark.parametrize("path", [False, "per_slot"])
def test_sparse_tokenized_matches_jax(path):
    """Token accounts on a sparse topology: the reaction waves draw their
    peers into the CSR rows under ``K_REACT_PEER + 10 j``."""
    tsim, tst, trep = check_variant(tokenized, 35, 8, fused_merge=path)
    assert (tst.aux["balance"] != 0).any()
    assert trep.sent_messages > 0


# -- All2All over SparseMixing ------------------------------------------------

A2A_CHAOS = ChaosConfig(
    partitions=(PartitionEpisode(components=(tuple(range(N // 2)),
                                             tuple(range(N // 2, N))),
                                 start=1, stop=3),),
    churn=ChurnProcess(keep_frac=0.6, start=2, stop=5, period=1, seed=2))


def all2all(mixing, form, chaos):
    def build(key, **kw):
        if chaos:
            kw = {"chaos": A2A_CHAOS, "probes": True, "sentinels": True,
                  **kw}
        return make("All2AllGossipSimulator", logreg("weighted"), regular(),
                    data(), key, mixing=mixing, sparse_mix_form=form,
                    sync=False, drop_prob=0.1, online_prob=0.8, **kw)
    return build


ALL2ALL = {(m, f, c): all2all(m, f, c)
           for m in ("uniform_mixing", "metropolis_hastings_mixing")
           for f in ("padded", "segment") for c in (False, True)}


@pytest.mark.parametrize("chaos", [False, True])
@pytest.mark.parametrize("form", ["padded", "segment"])
@pytest.mark.parametrize("mixing", ["uniform_mixing",
                                    "metropolis_hastings_mixing"])
def test_sparse_all2all_matches_jax(mixing, form, chaos):
    """Each sparse form against the JAX simulator in the same form: the
    padded one draws its drops over ``[N, max_deg]``, the segment one
    over ``[2E]``; under chaos the CSR masks cut the mixed edges."""
    key_seed = 36
    tsim, _, trep = check_variant(ALL2ALL[(mixing, form, chaos)], key_seed,
                                  5)
    assert tsim.sparse_mix and tsim._sparse_padded == (form == "padded")
    causes = trep.failed_per_cause
    assert causes["drop"].sum() > 0 and causes["offline"].sum() > 0
    if chaos:
        jsim, _, _, jrep = tp.reference(ALL2ALL[(mixing, form, chaos)],
                                        key_seed, 5)
        tp.assert_same_telemetry(jrep, trep)
        assert trep.chaos_component_gap is not None


@pytest.mark.parametrize("form", ["padded", "segment"])
def test_sparse_all2all_equals_dense(form):
    """The port alone, no drops: the sparse forms give the dense
    ``W_eff @ P`` run (the JAX test ``test_all2all_sparse_equals_dense``);
    the summation order differs, so params are held within 1e-5. Both
    draw from the oracle's per-purpose keys, so the drop draw's shape
    moves no other draw."""
    topo = regular()
    key = jax.random.PRNGKey(5)
    results = []
    for t, kw in ((topo.to_dense(), {}), (topo, {"sparse_mix_form": form})):
        sim = tsimulation.All2AllGossipSimulator(
            logreg("weighted")[1], t, data(), delta=8,
            mixing=tcore.uniform_mixing(t), device="cpu",
            draws=JaxDraws(key, init_key=key), **kw)
        st = sim.init_nodes(torch.Generator().manual_seed(3))
        st, rep = sim.start(st, n_rounds=4)
        results.append((st, rep))
    (sd, rd), (ss, rs) = results
    np.testing.assert_allclose(ss.model.params.numpy(),
                               sd.model.params.numpy(), atol=1e-5)
    assert torch.equal(ss.model.n_updates, sd.model.n_updates)
    np.testing.assert_array_equal(rs.sent_per_round, rd.sent_per_round)
    np.testing.assert_allclose(rs.curves(local=False)["accuracy"],
                               rd.curves(local=False)["accuracy"], atol=1e-6)


def test_sparse_all2all_refusals():
    """The JAX simulator's checks: padded refused on a hub graph, rows
    out of CSR order, a node-count mismatch, dense mixing over a sparse
    topology; ``"auto"`` is the segment form."""
    h = logreg("weighted")[1]
    hub = tcore.SparseTopology.barabasi_albert(200, 1, seed=1)
    with pytest.raises(ValueError, match="heavy-tailed"):
        tsimulation.All2AllGossipSimulator(
            h, hub, data(200), mixing=tcore.uniform_mixing(hub),
            sparse_mix_form="padded", device="cpu")
    topo = regular()
    mix = tcore.uniform_mixing(topo)
    shuffled = mix._replace(rows=mix.rows[::-1].copy())
    with pytest.raises(ValueError, match="non-decreasing"):
        tsimulation.All2AllGossipSimulator(h, topo, data(), mixing=shuffled,
                                           device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        tsimulation.All2AllGossipSimulator(
            h, topo, data(), mixing=mix._replace(num_nodes=N + 1),
            device="cpu")
    with pytest.raises(ValueError, match="SparseMixing"):
        tsimulation.All2AllGossipSimulator(
            h, topo, data(), mixing=tcore.uniform_mixing(topo.to_dense()),
            device="cpu")
    sim = tsimulation.All2AllGossipSimulator(h, topo, data(), mixing=mix,
                                             device="cpu")
    assert sim.sparse_mix and not sim._sparse_padded
    np.testing.assert_allclose(sim._probe_expected_fanin(),
                               topo.degrees.astype(np.float64))


# -- the scale twin -----------------------------------------------------------

def jax_scale_sim(n, rounds, topo, stacked, all2all, **kw):
    """The JAX scale rows' simulators (``bench.py::bench_scale`` and
    ``bench_scale_all2all``) over ``topo``, without their perf counters
    (``kw``: a deliver path)."""
    d = scale.FEATURES
    cls = WeightedSGDHandler if all2all else SGDHandler
    handler = cls(model=LogisticRegression(d, 2), loss=losses.cross_entropy,
                  optimizer=optax.sgd(0.1), local_epochs=1, batch_size=4,
                  n_classes=2, input_shape=(d,),
                  create_model_mode=CreateModelMode.MERGE_UPDATE)
    if all2all:
        return JAll2All(handler, topo, stacked, delta=scale.ROUND_LEN,
                        mixing=jcore.uniform_mixing(topo),
                        sampling_eval=0.01, eval_every=rounds)
    return JGossipSimulator(handler, topo, stacked, delta=scale.ROUND_LEN,
                            protocol=AntiEntropyProtocol.PUSH,
                            sampling_eval=0.01, eval_every=rounds,
                            history_dtype=scale.HISTORY_DTYPE, **kw)


@pytest.mark.parametrize("row", ["vanilla", "vanilla-plain", "all2all"])
def test_scale_twin_matches_the_jax_scale_row(row):
    """The twin's configuration at 64 nodes (degree 20) against the JAX
    scale row's, under the oracle: its data is the JAX harness's data,
    and the run's accounting, boxes, params and final accuracy agree.
    The twin's vanilla row takes the port's default deliver, the
    single-pass fused one, held against the JAX engine on the same path;
    on the JAX harness's own (plain) path the two agree too."""
    all2all = row == "all2all"
    paths = {"vanilla": {"fused_merge": "multi"},
             "vanilla-plain": {"fused_merge": False}, "all2all": {}}
    n, rounds = 64, 5
    rng = np.random.default_rng(42)
    w = rng.normal(size=scale.FEATURES)
    X = rng.normal(size=(4 * n, scale.FEATURES)).astype(np.float32)
    y = (X @ w > 0).astype(np.int64)
    eval_cap = min(2048, int(0.2 * len(X)))
    jstacked = DataDispatcher(
        ClassificationDataHandler(X, y, test_size=eval_cap / len(X)),
        n=n, eval_on_user=False).stacked()
    tstacked = scale.scale_data(n)
    for k, v in jstacked.items():
        np.testing.assert_array_equal(np.asarray(tstacked[k]), np.asarray(v),
                                      err_msg=k)
    key = jax.random.PRNGKey(42)
    jtopo = jcore.SparseTopology.random_regular(n, scale.DEGREE, seed=42)
    ttopo = tcore.SparseTopology.random_regular(n, scale.DEGREE, seed=42)
    jsim = jax_scale_sim(n, rounds, jtopo, jstacked, all2all, **paths[row])
    build = scale.build_all2all if all2all else scale.build_vanilla
    port_kw = {"fused_merge": False} if row == "vanilla-plain" else {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tsim = build(n, rounds, ttopo, data=tstacked,
                     draws=JaxDraws(key, init_key=key), device="cpu",
                     **port_kw)
    if row == "vanilla":
        # The twin's default deliver is the single-pass fused one.
        assert tsim.fused_merge == "multi"
    jst = jsim.init_nodes(key)
    tst = tp.to_port_state(tsim, jst)
    jst, jrep = jsim.start(jst, n_rounds=rounds, key=key,
                           donate_state=False)
    tst, trep = tsim.start(tst, n_rounds=rounds)
    tp.assert_same_run(jsim, tsim, jst, tst, jrep, trep)
    assert trep.curves(local=False)["accuracy"][-1] == pytest.approx(
        jrep.curves(local=False)["accuracy"][-1], abs=1e-6)
