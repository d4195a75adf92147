"""The port's sequential engine against the JAX package's, under the oracle.

``gossipy_tpu_torch.simulation.SequentialGossipSimulator`` and
``gossipy_tpu.simulation.SequentialGossipSimulator`` run the same
configuration on the same numpy data from the same weights (the JAX
``init_nodes`` result, its per-node states stacked and converted), the
port drawing through ``torch_oracle.JaxDraws``: the two host generators'
seeds from ``split(key)[0]``, every handler call, delay sample and token
reaction from ``fold_in(split(key)[1], e)`` in the JAX engine's order.

Held exactly (``torch_pairs.assert_same_seq_run``): every per-message
event in order (failed flag, tick, round, sender, receiver, type, size),
the replayed per-round events, sent, failed and the failures by cause
per round, the total size, the token balances, the phases and the ages;
the probes' staleness and accepted counts, the sentinels' integer
vitals. Within 1e-5: params (Pegasos's, whose weights reach hundreds,
within 1e-5 plus 1e-6 of the value), the metric curves, the probe
deltas, consensus, the chaos gap and the sentinels' float vitals
(1e-5 relative plus 1e-6).

The configurations: PUSH with drops and offline receivers, PUSH_PULL
and PULL with random delays (zero-delay replies cascade in the tick),
PULL with a size-proportional delay, async nodes, the randomised token
account with same-tick reactions, a generalised one with a utility that
reads the receiver's model, the pass-through and neighbour-cache
variants on a power-law graph, scheduled chaos (outage, partition, drop
and delay spikes) with probes and sentinels, a sampled evaluation, the
UPDATE and UPDATE_MERGE modes, a chunked run (two ``start`` calls, the
chaos schedule keyed on absolute rounds), k-means (a second handler
family, its matching greedy on one stacked row as in the JAX engine's
jitted single-node merge) and ``run_repetitions`` of Pegasos.
"""

import jax
import numpy as np
import pytest
import torch

from gossipy_tpu import flow_control as jflow
from gossipy_tpu.handlers import KMeansHandler
from gossipy_tpu_torch import core as tcore
from gossipy_tpu_torch import flow_control as tflow
from gossipy_tpu_torch.core import AntiEntropyProtocol, CreateModelMode, \
    LinearDelay, UniformDelay
from gossipy_tpu_torch.handlers import KMeansHandler as TKMeansHandler
from gossipy_tpu_torch.simulation import ChaosConfig, FaultSpike, \
    OutageEpisode, PartitionEpisode
from torch_oracle import JaxDraws
from torch_pairs import PEGASOS_RTOL, assert_same_seq_run, handlers, \
    logreg, pegasos, seq_pair, seq_to_port_state, small_data

N, ROUNDS = 12, 5


def chaos_config(rounds=ROUNDS):
    half = N // 2
    return ChaosConfig(
        outages=(OutageEpisode(nodes=(0, 1, 2), start=1, stop=3),),
        partitions=(PartitionEpisode(components=(
            tuple(range(half)), tuple(range(half, N))), start=2, stop=4),),
        spikes=(FaultSpike(start=1, stop=3, drop_prob=0.3,
                           delay_scale=2.0),),
        horizon=rounds)


def topology(kind):
    if kind == "ba":
        return tcore.Topology.barabasi_albert(N, 2, seed=1)
    return tcore.Topology.random_regular(N, 4, seed=5)


# label: (the port's simulator options, topology, handler)
CONFIGS = {
    "push-drop-online": (dict(drop_prob=0.2, online_prob=0.8), "rr", "sgd"),
    "push_pull-delay": (dict(protocol=AntiEntropyProtocol.PUSH_PULL,
                             delay=UniformDelay(0, 30)), "rr", "sgd"),
    "pull-delay": (dict(protocol=AntiEntropyProtocol.PULL,
                        delay=UniformDelay(0, 30)), "rr", "sgd"),
    "pull-linear-delay": (dict(protocol=AntiEntropyProtocol.PULL,
                               delay=LinearDelay(0.5, 1)), "rr", "sgd"),
    "async": (dict(sync=False, drop_prob=0.1, delay=UniformDelay(0, 10)),
              "rr", "sgd"),
    "tokenized": (dict(token_account=tflow.RandomizedTokenAccount(C=4, A=2),
                       delay=UniformDelay(0, 10)), "rr", "sgd"),
    "passthrough": (dict(variant="passthrough"), "ba", "sgd"),
    "cache_neigh": (dict(variant="cache_neigh", delay=UniformDelay(0, 10)),
                    "ba", "sgd"),
    "chaos-probes-sentinels": (dict(chaos=chaos_config(), probes=True,
                                    sentinels=True,
                                    delay=UniformDelay(0, 10)), "rr", "sgd"),
    "probes-sentinels": (dict(probes=True, sentinels=True), "rr", "sgd"),
    "sampled-eval": (dict(sampling_eval=0.5), "rr", "sgd"),
    "update": (dict(delay=UniformDelay(0, 10)), "rr", "update"),
    "update_merge": (dict(), "rr", "update_merge"),
}


def pair_handlers(kind):
    if kind == "sgd":
        return handlers(10, 8)
    mode = {"update": CreateModelMode.UPDATE,
            "update_merge": CreateModelMode.UPDATE_MERGE}[kind]
    return logreg("sgd", mode)


def run_pair(kw, topo_kind="rr", handler_kind="sgd", seed=3,
             rounds=ROUNDS, handlers_=None, data=None, **tol):
    key = jax.random.PRNGKey(seed)
    jsim, tsim, jlog, tlog = seq_pair(
        handlers_ or pair_handlers(handler_kind), topology(topo_kind),
        small_data() if data is None else data, key, **kw)
    jst = jsim.init_nodes(key)
    tst = seq_to_port_state(tsim, jst)
    jst, jrep = jsim.start(jst, n_rounds=rounds,
                           key=jax.random.fold_in(key, 1))
    tst, trep = tsim.start(tst, n_rounds=rounds)
    assert_same_seq_run(jsim, tsim, jst, tst, jrep, trep, jlog, tlog, **tol)
    return tsim, tst, trep, tlog


def sends(log):
    return [e for e in log.events if not e[0]]


@pytest.mark.parametrize("label", sorted(CONFIGS))
def test_matches_jax_sequential(label):
    kw, topo_kind, handler_kind = CONFIGS[label]
    tsim, tst, trep, tlog = run_pair(kw, topo_kind, handler_kind)
    assert trep.sent_messages > 0
    causes = {c: int(v.sum()) for c, v in trep.failed_per_cause.items()}
    # Each configuration shows what it is there for.
    if label == "push-drop-online":
        assert causes["drop"] > 0 and causes["offline"] > 0
    if label.startswith(("push_pull", "pull")):
        assert any(e[5] == int(tcore.MessageType.REPLY) for e in sends(tlog))
    if label == "tokenized":
        off_phase = [e for e in sends(tlog)
                     if e[1] % tsim.delta != int(tst.phase[e[3]])]
        assert off_phase and tst.balance.sum() > 0
    if label.startswith("chaos"):
        assert causes["chaos"] > 0 and trep.chaos_component_gap is not None
    if "probes" in label:
        assert np.isfinite(trep.probe_merge_delta).all()
        assert trep.probe_accepted_per_node.sum() > 0


def test_generalized_tokens_with_a_model_utility():
    """A utility read from the receiver's own model (its age), the same
    function in each package's terms."""
    key = jax.random.PRNGKey(4)
    acc = tflow.GeneralizedTokenAccount(C=3, A=2)
    jsim, tsim, jlog, tlog = seq_pair(
        handlers(10, 8), topology("rr"), small_data(), key,
        delay=UniformDelay(0, 5), token_account=acc)
    jsim.utility_fun = lambda recv, snap: float(recv.n_updates > 4)
    tsim.utility_fun = lambda recv, snap: float(recv.n_updates[0] > 4)
    assert isinstance(jsim.account, jflow.GeneralizedTokenAccount)
    jst = jsim.init_nodes(key)
    tst = seq_to_port_state(tsim, jst)
    jst, jrep = jsim.start(jst, n_rounds=ROUNDS,
                           key=jax.random.fold_in(key, 1))
    tst, trep = tsim.start(tst, n_rounds=ROUNDS)
    assert_same_seq_run(jsim, tsim, jst, tst, jrep, trep, jlog, tlog)
    assert trep.sent_messages > 0


def test_chunked_run_matches_jax():
    """Two ``start`` calls: the host seeds and the event counter start
    afresh in each, and the chaos schedule keys on absolute rounds."""
    key = jax.random.PRNGKey(6)
    kw = dict(chaos=chaos_config(6), probes=True, sentinels=True,
              delay=UniformDelay(0, 10))
    jsim, tsim, jlog, tlog = seq_pair(handlers(10, 8), topology("rr"),
                                      small_data(), key, **kw)
    jst = jsim.init_nodes(key)
    tst = seq_to_port_state(tsim, jst)
    for part in range(2):
        run_key = jax.random.fold_in(key, 10 + part)
        tsim.draws = JaxDraws(run_key)
        jst, jrep = jsim.start(jst, n_rounds=3, key=run_key)
        tst, trep = tsim.start(tst, n_rounds=3)
        assert_same_seq_run(jsim, tsim, jst, tst, jrep, trep, jlog, tlog)
    assert tst.round == 6


def test_kmeans_matches_jax_sequential():
    """A handler family with no optimizer and no shard orders: each
    event still advances the counter. On one stacked row the port's
    merge takes the greedy matching, as the JAX engine's jitted
    single-node merge does."""
    hs = (KMeansHandler(k=2, dim=10, alpha=0.1, matching="hungarian"),
          TKMeansHandler(k=2, dim=10, alpha=0.1, matching="hungarian"))
    _, tst, trep, _ = run_pair(dict(delay=UniformDelay(0, 10),
                                    drop_prob=0.1), handlers_=hs)
    assert trep.sent_messages > 0
    assert np.isfinite(trep.curves(False)["nmi"]).all()


def test_pegasos_run_repetitions_match_jax():
    """``run_repetitions`` under the oracle of each repetition's split
    keys: the JAX engine runs ``init_nodes(k_init)`` then ``start(key=
    fold_in(k_run, 2))``. Pegasos starts from zeros in both packages, so
    the port's own ``init_nodes`` (and its pre-training on the
    ``fold_in(k_up, i)`` orders) is held too."""
    key = jax.random.PRNGKey(9)
    jh, th = pegasos()
    jsim, tsim, jlog, tlog = seq_pair((jh, th), topology("rr"),
                                      small_data(signed=True), key,
                                      delay=UniformDelay(0, 10))
    keys = jax.random.split(key, 2)
    draws = []
    for k in keys:
        k_init, k_run = jax.random.split(k)
        draws.append(JaxDraws(jax.random.fold_in(k_run, 2), init_key=k_init))
    jsts, jreps = jsim.run_repetitions(3, keys)
    tsts, treps = tsim.run_repetitions(3, [0, 1], draws=draws)
    assert isinstance(tsim.draws, JaxDraws) and len(treps) == 2
    for jst, tst, jrep, trep in zip(jsts, tsts, jreps, treps):
        assert_same_seq_run(jsim, tsim, jst, tst, jrep, trep, None, None,
                            param_rtol=PEGASOS_RTOL)
        assert trep.sent_messages > 0
    assert tlog.events == jlog.events and tlog.rounds == jlog.rounds
    assert not torch.equal(tsts[0].model.params, tsts[1].model.params)
