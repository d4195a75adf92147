"""The port's sequential engine on its own: the semantics the JAX package's
``tests/test_sequential.py`` and ``test_sequential_parity.py::
TestVariantSequentialParity`` hold, the payload copy, the pre-training
under the oracle, the bulk engine beside it, and the audit twin.

- per-message events and accounting on a fault-free PUSH run; an
  isolated node skips its send and the others still send;
- pass-through on a clique (every accept probability 1) is the vanilla
  run bit for bit; the variants change the trajectory on a power-law
  graph; an unknown variant, and a variant with a token account, raise;
- a delayed message carries its sender's row as it was at the send:
  with a constant delay, senders that merged between their send and
  its delivery exist, and the run still equals the JAX engine's;
- ``init_nodes`` under the oracle equals the JAX ``init_nodes`` from the
  same initial weights (per-node pre-training keys, the phase seed);
- the sequential engine against the port's bulk engine: 3-seed mean
  accuracy curves within 0.06 and equal message counts;
- without a card the entry point raises unless ``device="cpu"``; past
  512 nodes it warns;
- the audit twin runs on the host, plain and ``--tokenized``.
"""

import jax
import numpy as np
import pytest
import torch

from gossipy_tpu_torch import core as tcore
from gossipy_tpu_torch.convert import params_from_jax
from gossipy_tpu_torch.core import ConstantDelay
from gossipy_tpu_torch.examples import audit_fidelity
from gossipy_tpu_torch.flow_control import RandomizedTokenAccount
from gossipy_tpu_torch.handlers import ModelState as TModelState
from gossipy_tpu_torch.random import TorchDraws
from gossipy_tpu_torch.simulation import GossipSimulator, \
    SequentialGossipSimulator, SimulationEventReceiver
from gossipy_tpu.data import ClassificationDataHandler as \
    jClassificationDataHandler
from gossipy_tpu.data import DataDispatcher as jDataDispatcher
from gossipy_tpu.simulation import GossipSimulator as jGossipSimulator
from gossipy_tpu_torch.data import ClassificationDataHandler, DataDispatcher
from torch_oracle import JaxDraws
from torch_pairs import MessageLog, assert_same_seq_run, handlers, \
    jax_topology, seq_pair, seq_to_port_state, small_data, \
    stack_models, to_port_state

N, D, DELTA = 16, 12, 20


class Log(MessageLog, SimulationEventReceiver):
    def __init__(self):
        super().__init__()
        self.steps = 0

    def update_timestep(self, round):
        self.steps += 1


def port_handler():
    return handlers(D, 32)[1]


def parts(seed=0, n=N):
    """The JAX ``tests/test_sequential.py`` set-up in the port: 480
    samples of a 12-feature separable set, ``random_regular(n, 6)``."""
    return audit_fidelity.audit_data(n, seed)[0], \
        tcore.Topology.random_regular(n, 6, seed=7)


def seq(topo, data, seed=0, **kw):
    return SequentialGossipSimulator(port_handler(), topo, data, delta=DELTA,
                                     draws=TorchDraws(seed), device="cpu",
                                     **kw)


def final_rows(state):
    return state.model.params.clone()


def test_push_accounting_and_per_message_events():
    data, topo = parts()
    sim = seq(topo, data)
    log = Log()
    sim.add_receiver(log)
    st = sim.init_nodes(torch.Generator().manual_seed(0))
    st, rep = sim.start(st, n_rounds=6)
    sends = [e for e in log.events if not e[0]]
    assert rep.sent_messages == 6 * N == len(sends)
    assert rep.failed_messages == 0 and log.steps == 6
    assert [r[1] for r in log.rounds if len(r) == 4] == [N] * 6
    assert st.round == 6 and st.model.params.device.type == "cpu"
    acc = rep.curves(local=False)["accuracy"]
    assert np.isfinite(acc).all() and acc[-1] > acc[0]


def test_isolated_node_skips_not_aborts():
    """The reference breaks the whole sweep at an isolated sender; here
    it only skips itself."""
    adj = np.zeros((4, 4), dtype=bool)
    adj[0, 1] = adj[1, 0] = adj[1, 2] = adj[2, 1] = True
    data = audit_fidelity.audit_data(4, 0)[0]
    sim = seq(tcore.Topology(adj), data)
    st = sim.init_nodes(torch.Generator().manual_seed(0))
    st, rep = sim.start(st, n_rounds=4)
    assert rep.sent_messages == 4 * 3


def test_passthrough_on_a_clique_is_vanilla_bit_for_bit():
    data, _ = parts(11)
    finals, curves = [], []
    for variant in (None, "passthrough"):
        sim = seq(tcore.Topology.clique(N), data, seed=3, variant=variant)
        st = sim.init_nodes(torch.Generator().manual_seed(3))
        st, rep = sim.start(st, n_rounds=6)
        finals.append(final_rows(st))
        curves.append(rep.curves(local=False)["accuracy"])
    assert torch.equal(finals[0], finals[1])
    np.testing.assert_array_equal(curves[0], curves[1])


def test_variants_change_the_trajectory():
    data, _ = parts(14)
    topo = tcore.Topology.barabasi_albert(N, 2, seed=2)
    finals = {}
    for variant in (None, "passthrough", "cache_neigh"):
        sim = seq(topo, data, seed=5, variant=variant)
        st = sim.init_nodes(torch.Generator().manual_seed(5))
        st, _ = sim.start(st, n_rounds=6)
        finals[variant] = final_rows(st)
    assert not torch.equal(finals[None], finals["passthrough"])
    assert not torch.equal(finals[None], finals["cache_neigh"])
    assert not torch.equal(finals["passthrough"], finals["cache_neigh"])


def test_variant_argument_validation():
    data, _ = parts()
    with pytest.raises(ValueError, match="unknown sequential variant"):
        seq(tcore.Topology.clique(N), data, variant="pens")
    with pytest.raises(ValueError, match="mutually"):
        seq(tcore.Topology.clique(N), data, variant="passthrough",
            token_account=RandomizedTokenAccount(C=20, A=10))
    with pytest.raises(ValueError, match="drop_prob"):
        seq(tcore.Topology.clique(N), data, drop_prob=1.0)


def test_delayed_payload_is_the_senders_row_at_send_time():
    """With a constant delay of 15 ticks (delta 20), a sender that
    receives a message in between its send and that send's delivery
    merges before its message lands: the payload must be the row as it
    was sent (a copy), not the row as it is at delivery. Such senders
    are in the run, and the run equals the JAX engine's, whose payloads
    are immutable."""
    key = jax.random.PRNGKey(8)
    jsim, tsim, jlog, tlog = seq_pair(handlers(10, 8),
                                      tcore.Topology.random_regular(
                                          12, 4, seed=5),
                                      small_data(), key,
                                      delay=ConstantDelay(15))
    jst = jsim.init_nodes(key)
    tst = seq_to_port_state(tsim, jst)
    jst, jrep = jsim.start(jst, n_rounds=5, key=jax.random.fold_in(key, 1))
    tst, trep = tsim.start(tst, n_rounds=5)
    assert_same_seq_run(jsim, tsim, jst, tst, jrep, trep, jlog, tlog)
    sends = [e for e in tlog.events if not e[0]]
    # (send tick, sender) of each message, and the ticks each node
    # received (merged) one: a send's own delivery lands 15 ticks later.
    got = {}
    for e in sends:
        got.setdefault(e[4], []).append(e[1] + 15)
    stale = [e for e in sends
             if any(e[1] <= t < e[1] + 15 for t in got.get(e[3], ()))]
    assert stale, "no sender merged between its send and the delivery"
    # The payload is a copy: writing the row leaves it as it was.
    model = tst.model
    view = tsim._peer_view(model, 0)
    before = view.params.clone()
    model.params[0] += 1.0
    assert torch.equal(view.params, before)


def test_init_nodes_matches_jax_init_nodes():
    """``init_nodes`` under the oracle: node ``i`` pre-trains on the
    orders of the JAX ``fold_in(k_up, i)``, the phases come from the
    ``k_phase`` seed; the initial weights are the JAX ``common_init``
    ones, handed to the port's ``init``."""
    key = jax.random.PRNGKey(5)
    jsim, tsim, _, _ = seq_pair(handlers(10, 8),
                                tcore.Topology.random_regular(12, 4, seed=5),
                                small_data(), key)
    jst = jsim.init_nodes(key, common_init=True)
    k_init = jax.random.split(key, 3)[0]
    one = params_from_jax(jax.tree.map(np.asarray,
                                       jsim.handler.init(k_init).params),
                          tsim.handler.layout, stacked=False)
    tsim.handler.init = lambda generator=None, device=None: TModelState(
        one.clone(), (), torch.zeros((), dtype=torch.int32))
    tst = tsim.init_nodes(common_init=True)
    want = seq_to_port_state(tsim, jst)
    assert torch.allclose(tst.model.params, want.model.params, atol=1e-5)
    assert torch.equal(tst.model.n_updates, want.model.n_updates)
    np.testing.assert_array_equal(tst.phase, np.asarray(jst.phase))
    assert (stack_models(jst.models).n_updates > 0).all()


def test_mean_curves_agree_with_the_bulk_engine():
    """The two engines' divergences (in-round snapshots, same-tick
    reactions) are bounded: on the JAX ``tests/test_sequential.py``
    configuration (its data, graph and seeds 100-102, each engine from
    the JAX engine's initial state of that seed and under the oracle of
    its keys), the port's two engines' 3-seed mean accuracy curves agree
    within 0.06, and send the same messages on fault-free PUSH."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(480, D)).astype(np.float32)
    y = (X @ rng.normal(size=D) > 0).astype(np.int64)
    jdata = jDataDispatcher(jClassificationDataHandler(
        X, y, test_size=0.25, seed=1), n=N, eval_on_user=False).stacked()
    data = DataDispatcher(ClassificationDataHandler(
        X, y, test_size=0.25, seed=1), n=N, eval_on_user=False).stacked()
    topo = tcore.Topology.random_regular(N, 6, seed=7)
    curves = {"seq": [], "bulk": []}
    sent = {}
    for s in range(3):
        key = jax.random.PRNGKey(100 + s)
        draws = JaxDraws(jax.random.fold_in(key, 1), init_key=key)
        jseq, tseq, _, _ = seq_pair(handlers(D, 32), topo, jdata, key)
        tst = seq_to_port_state(tseq, jseq.init_nodes(key))
        jh, th = handlers(D, 32)
        jbulk = jGossipSimulator(jh, jax_topology(topo), jdata, delta=DELTA)
        tbulk = GossipSimulator(th, topo, data, delta=DELTA, draws=draws,
                                device="cpu")
        bst = to_port_state(tbulk, jbulk.init_nodes(key))
        for name, sim, st in (("seq", tseq, tst), ("bulk", tbulk, bst)):
            _, rep = sim.start(st, n_rounds=8)
            curves[name].append(rep.curves(local=False)["accuracy"])
            sent[name] = rep.sent_messages
    gap = np.max(np.abs(np.mean(curves["seq"], 0)
                        - np.mean(curves["bulk"], 0)))
    assert gap < 0.06, f"sequential/bulk mean-curve gap {gap:.3f}"
    assert sent["seq"] == sent["bulk"] > 0


def test_entry_point_needs_cuda_unless_cpu(monkeypatch):
    data, topo = parts()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SequentialGossipSimulator(port_handler(), topo, data)
    assert seq(topo, data).device.type == "cpu"


def test_large_population_warns():
    n = 513
    data = audit_fidelity.audit_data(n, 0)[0]
    with pytest.warns(UserWarning, match="513 nodes will be slow"):
        seq(tcore.Topology.ring(n), data)


@pytest.mark.parametrize("tokenized", [False, True])
def test_audit_twin_on_the_host(tokenized):
    argv = ["--device", "cpu", "--nodes", "8", "--rounds", "3", "--seeds",
            "2"] + (["--tokenized"] if tokenized else [])
    out = audit_fidelity.main(argv)
    assert out["tokenized"] == tokenized and out["rounds"] == 3
    assert sorted(out) == ["final", "max_accuracy_gap", "max_sent_gap",
                           "nodes", "rounds", "seeds", "tail_accuracy_gap",
                           "tokenized"]
    assert all(np.isfinite(v) for v in out["final"].values())
    assert 0 <= out["max_accuracy_gap"] < 0.5
