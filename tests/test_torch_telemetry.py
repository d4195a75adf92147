"""The port's events, gossip-dynamics probes and numerics sentinels against
the JAX package's.

The events module is a copy: the same per-round stats replay into the same
receiver calls and byte-equal JSON lines, and the JAX reader parses the
port's file. The probes and sentinels run in both engines from the same
state under the JAX draw oracle (``tests/torch_oracle.py``), on each
deliver path (plain with its compacted and wide passes, per-slot, the
single-pass multi, compacted and wide), and every ``probe_*`` and
``health_*`` array of the two reports is held: integers exactly, floats
within 1e-5 of the value plus 1e-6 (``torch_pairs.assert_same_telemetry``;
the two frameworks sum in different orders). The merge and train deltas
are NaN in both where the decomposition is not exact. A NaN and an
outsized weight written into the params mid-run trip the sentinels in the
same round, slot and leaf in both, with the carry continued across
``start()`` calls. With telemetry off a round emits exactly the stats it
emitted before, with the same values.
"""

import json

import jax
import numpy as np
import pytest
import torch

import torch_pairs as tp
from gossipy_tpu import core as jcore
from gossipy_tpu.simulation import events as jevents
from gossipy_tpu_torch import core as tcore
from gossipy_tpu_torch.core import AntiEntropyProtocol, CreateModelMode, \
    UniformDelay
from gossipy_tpu_torch.simulation import events as tevents
from gossipy_tpu_torch.telemetry import ProbeConfig, SentinelConfig

ROUNDS = 5
# Every path of the deliver: plain wide, plain compacted (capacity 4, its
# overflow to the wide pass included), per-slot, multi wide and compacted.
PATH_CASES = ("plain", "plain-compact", "per_slot", "multi",
              "multi-compact")


def pair(key, path="multi", topo=None, **kw):
    """A 12-node 4-regular configuration in both engines on ``path``."""
    fused, cap = tp.PATHS[path]
    topo = topo if topo is not None else tcore.Topology.random_regular(
        tp.N, 4, seed=5)
    data = tp.small_data()
    return tp.make_pair(jcore.Topology(topo.adjacency), topo, data, data,
                        key, fused_merge=fused, compact_deliver=cap, **kw)


def start_pair(jsim, tsim, key, rounds=ROUNDS):
    jst = jsim.init_nodes(key, common_init=True)
    tst = tp.to_port_state(tsim, jst)
    return jst, tst


def run_pair(jsim, tsim, jst, tst, key, rounds=ROUNDS):
    jst, jrep = jsim.start(jst, n_rounds=rounds, key=key,
                           donate_state=False)
    tst, trep = tsim.start(tst, n_rounds=rounds)
    return jst, tst, jrep, trep


# -- events ------------------------------------------------------------------

def synthetic_stats(rounds=4, n=5, layers=2, seed=0):
    """A stats dict with every key the replay reads, as host arrays: a
    skipped evaluation (NaN row) in round 1, NaN merge deltas in round 2."""
    rng = np.random.default_rng(seed)
    i32 = lambda *s: rng.integers(0, 9, size=s).astype(np.int32)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    local = f32(rounds, 2)
    local[1] = np.nan
    merge = np.abs(f32(rounds))
    merge[2] = np.nan
    return {
        "sent": i32(rounds), "failed": i32(rounds), "size": i32(rounds),
        "failed_drop": i32(rounds), "failed_offline": i32(rounds),
        "failed_overflow": i32(rounds), "failed_chaos": i32(rounds),
        "local": local, "global": f32(rounds, 2),
        "probe_consensus_mean": f32(rounds), "probe_consensus_max": f32(rounds),
        "probe_consensus_per_layer": f32(rounds, layers),
        "probe_stale_mean": f32(rounds), "probe_stale_max": i32(rounds),
        "probe_stale_hist": i32(rounds, 8),
        "probe_accepted_per_node": i32(rounds, n),
        "probe_merge_delta": merge, "probe_train_delta": merge + 1,
        "health_nonfinite_params": i32(rounds, layers),
        "health_nonfinite_delta": i32(rounds, layers),
        "health_nonfinite_metrics": i32(rounds),
        "health_first_bad_slot": i32(rounds) - 1,
        "health_mix_nonfinite": i32(rounds),
        "health_diverged_per_node": i32(rounds, n),
        "health_param_norm_max": f32(rounds), "health_delta_norm": f32(rounds),
        "health_delta_hwm": f32(rounds), "health_mailbox_hwm_run": i32(rounds),
        "health_trip": i32(rounds) % 2,
        "chaos_component_gap": f32(rounds), "chaos_within_mean": f32(rounds),
        "chaos_active_components": i32(rounds),
        "perf_round_ms": f32(rounds), "perf_mfu_est": f32(rounds),
    }


def replay(events_mod, path, stats, names):
    calls = []
    sender = type("S", (events_mod.SimulationEventSender,), {})()
    sender.add_receiver(events_mod.CallbackReceiver(calls.append))
    rx = events_mod.JSONLinesReceiver(str(path))
    sender.add_receiver(rx)
    sender.replay_events(3, stats, names)
    rx.close()
    return calls, path.read_bytes()


def test_events_replay_matches_jax(tmp_path):
    """The same stats give the same receiver calls and byte-equal JSON
    lines in both packages; the JAX reader parses the port's file."""
    stats = synthetic_stats()
    names = ["accuracy", "loss"]
    t_calls, t_bytes = replay(tevents, tmp_path / "t.jsonl", stats, names)
    j_calls, j_bytes = replay(jevents, tmp_path / "j.jsonl", stats, names)
    assert t_calls == j_calls
    assert t_bytes == j_bytes
    lines = t_bytes.decode().splitlines()
    assert len(lines) == 4
    rows = [jevents.JSONLinesReceiver.parse_line(ln) for ln in lines]
    assert [r["round"] for r in rows] == [4, 5, 6, 7]
    assert rows[1]["local"] is None and rows[2]["probes"]["merge_delta"] \
        is None
    assert rows[0]["failed_by_cause"]["chaos"] == int(stats["failed_chaos"][0])
    assert tevents.JSONLinesReceiver.parse_line(lines[0]) == rows[0]
    assert tevents.JSONLinesReceiver.SCHEMA == jevents.JSONLinesReceiver.SCHEMA


def test_live_receiver_sees_the_replayed_rows(tmp_path):
    """A live receiver is notified round by round during the run, with the
    payloads a replayed receiver gets after it; without a live receiver
    the run never notifies during the rounds."""
    key = jax.random.PRNGKey(2)
    _, tsim = pair(key, "multi", probes=True, sentinels=True)
    jsim, _ = pair(key, "multi")
    _, tst = start_pair(jsim, tsim, key)
    live, replayed = [], []
    tsim.add_receiver(tevents.CallbackReceiver(live.append, live=True))
    tsim.add_receiver(tevents.CallbackReceiver(replayed.append))
    seen_live = []
    orig = tsim._emit_live
    tsim._emit_live = lambda rnd, row: (seen_live.append(rnd),
                                        orig(rnd, row))
    tsim.start(tst, n_rounds=3)
    assert seen_live == [1, 2, 3]
    assert [r["round"] for r in live] == [1, 2, 3]
    assert json.dumps(live) == json.dumps(replayed)
    assert live[0]["probes"]["accepted_total"] >= 0
    assert "trip" in live[0]["health"]
    # Detached: no live notification.
    tsim.remove_receiver(tsim._receivers_list()[0])
    assert not tsim.has_live_receivers()
    seen_live.clear()
    tsim.start(tst, n_rounds=2)
    assert seen_live == []
    assert [r["round"] for r in replayed[3:]] == [4, 5]


# -- probes on each deliver path ---------------------------------------------

@pytest.mark.parametrize("path", PATH_CASES)
def test_probes_and_sentinels_match_jax(path):
    """PUSH_PULL with delays up to 1.5 rounds (staleness 0-2, replies in
    the reply box): the run, every probe and sentinel array, the layer
    names and the expected fan-in equal the JAX engine's on the same
    path."""
    key = jax.random.PRNGKey(4)
    kw = dict(probes=True, sentinels=True,
              protocol=AntiEntropyProtocol.PUSH_PULL,
              delay=UniformDelay(0, 150))
    if path.startswith("multi"):
        kw["protocol"] = AntiEntropyProtocol.PUSH
    jsim, tsim = pair(key, path, **kw)
    jst, tst = start_pair(jsim, tsim, key)
    jst, tst, jrep, trep = run_pair(jsim, tsim, jst, tst, key)
    tp.assert_same_run(jsim, tsim, jst, tst, jrep, trep)
    seen = tp.assert_same_telemetry(jrep, trep)
    assert "probe_merge_delta" in seen and "health_trip" in seen
    assert np.isfinite(trep.probe_merge_delta).all()
    assert trep.probe_stale_hist.sum() == trep.probe_accepted_per_node.sum()
    assert trep.probe_stale_max.max() > 0
    assert (trep.health_first_bad_slot == -1).all()
    assert trep.health_trip.sum() == 0


def test_probe_deltas_are_nan_where_not_exact():
    """Under UPDATE_MERGE the merge/train split is not exact: both engines
    report NaN deltas, and the counts and consensus still agree."""
    key = jax.random.PRNGKey(5)
    jh, th = tp.logreg(mode=CreateModelMode.UPDATE_MERGE)
    topo = tcore.Topology.random_regular(tp.N, 4, seed=5)
    jsim, tsim = tp.make(
        "GossipSimulator", (jh, th), topo, tp.small_data(), key,
        fused_merge=False, probes=ProbeConfig(staleness_buckets=4))
    jst, tst = start_pair(jsim, tsim, key)
    jst, tst, jrep, trep = run_pair(jsim, tsim, jst, tst, key, rounds=3)
    tp.assert_same_telemetry(jrep, trep)
    assert np.isnan(trep.probe_merge_delta).all()
    assert np.isnan(trep.probe_train_delta).all()
    assert trep.probe_stale_hist.shape == (3, 4)
    assert tsim._probe_delta_ok is False


# -- sentinels ---------------------------------------------------------------

def inject(jst, tst, tsim, node_nan=3, node_big=7, big=1e3):
    """A NaN in one node's first leaf and an outsized weight in another
    node's last leaf, written into both states."""
    layout = tsim.handler.layout
    leaves, tdef = jax.tree_util.tree_flatten(jst.model.params)
    first = leaves[0].reshape(leaves[0].shape[0], -1)
    first = first.at[node_nan, 0].set(np.nan)
    leaves[0] = first.reshape(leaves[0].shape)
    last = leaves[-1].reshape(leaves[-1].shape[0], -1)
    last = last.at[node_big, 0].set(big)
    leaves[-1] = last.reshape(leaves[-1].shape)
    jst = jst._replace(model=jst.model._replace(
        params=jax.tree_util.tree_unflatten(tdef, leaves)))
    name_last = layout.leaves[-1][0]
    p = tst.model.params.clone()
    p[node_nan, layout.offsets[layout.leaves[0][0]]] = float("nan")
    p[node_big, layout.offsets[name_last]] = big
    tst.model = tst.model._replace(params=p)
    return jst, tst


@pytest.mark.parametrize("path", ["plain", "multi"])
def test_sentinels_trip_on_injected_nan(path):
    """Two clean rounds, then a NaN and an outsized weight written into
    the params, then three more rounds (a second ``start()``: the EMA and
    the high-water marks carry over): both engines trip in the same round,
    name the same first bad slot and the same per-leaf counts, and flag
    the same diverged nodes."""
    key = jax.random.PRNGKey(6)
    jsim, tsim = pair(key, path, sentinels=True, probes=True)
    jst, tst = start_pair(jsim, tsim, key)
    jst, tst, jrep1, trep1 = run_pair(jsim, tsim, jst, tst, key, rounds=2)
    tp.assert_same_telemetry(jrep1, trep1)
    assert trep1.health_trip.sum() == 0
    carry = tsim._health_carry
    assert carry.rounds_seen == 2
    jst, tst = inject(jst, tst, tsim)
    jst, tst, jrep, trep = run_pair(jsim, tsim, jst, tst, key, rounds=3)
    tp.assert_same_accounting(jsim, tsim, jst, tst, jrep, trep)
    tp.assert_same_telemetry(jrep, trep, skip=("probe_consensus_mean",
                                               "probe_consensus_max",
                                               "probe_consensus_per_layer",
                                               "probe_merge_delta",
                                               "probe_train_delta"))
    assert tsim._health_carry.rounds_seen == 5
    assert trep.health_trip[0] == 1
    assert trep.health_nonfinite_params[0, 0] >= 1
    assert trep.health_first_bad_slot[0] >= 0
    assert trep.health_diverged_per_node[0, 7] == 1
    got = tsim.handler.layout.views(tst.model.params)
    for name, want in tp.flatten_names(jst.model.params).items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5, equal_nan=True)


def test_init_nodes_resets_the_carry():
    key = jax.random.PRNGKey(7)
    jsim, tsim = pair(key, "multi", sentinels=SentinelConfig(
        divergence=False))
    _, tst = start_pair(jsim, tsim, key)
    tsim.start(tst, n_rounds=2)
    assert tsim._health_carry.rounds_seen == 2
    tsim.init_nodes(torch.Generator().manual_seed(0))
    assert tsim._health_carry is None


# -- telemetry off ------------------------------------------------------------

BASE_KEYS = {"sent", "failed", "failed_drop", "failed_offline",
             "failed_overflow", "mailbox_hwm", "compact_slots", "wide_slots",
             "size", "local", "global"}


def test_telemetry_off_keeps_the_round_as_it_was():
    """Without probes, sentinels or chaos a round emits exactly the
    stats keys it emitted before and the report has no telemetry field;
    with them on, the run's accounting, params and metrics are the same
    bits."""
    key = jax.random.PRNGKey(8)
    jsim, off = pair(key, "multi-compact")
    _, on = pair(key, "multi-compact", probes=True, sentinels=True)
    jst = jsim.init_nodes(key, common_init=True)
    st_off = tp.to_port_state(off, jst)
    st_on = tp.to_port_state(on, jst)
    assert set(off._round(st_off, None)) == BASE_KEYS
    assert set(on._round(st_on, None)) > BASE_KEYS
    st_off, rep_off = off.start(st_off, n_rounds=3)
    st_on, rep_on = on.start(st_on, n_rounds=3)
    for f in tp.TELEMETRY_FIELDS:
        assert getattr(rep_off, f) is None, f
    assert sorted(rep_off.failed_per_cause) == ["drop", "offline",
                                                "overflow"]
    assert torch.equal(st_off.model.params, st_on.model.params)
    np.testing.assert_array_equal(rep_off.sent_per_round,
                                  rep_on.sent_per_round)
    assert rep_off.get_evaluation(False) == rep_on.get_evaluation(False)


# -- the variants -------------------------------------------------------------

def test_all2all_probes_and_mixing_sentinel_match_jax():
    """All2All's broadcast mixing: consensus, the bucket-0 staleness
    histogram, accepted in-edges, exact merge/train deltas, the mixing
    weights' non-finite count and the expected fan-in, as the JAX
    simulator reports them."""
    key = jax.random.PRNGKey(9)
    topo = tcore.Topology.random_regular(tp.N, 4, seed=5)
    jsim, tsim = tp.make("All2AllGossipSimulator", tp.logreg("weighted"),
                         topo, tp.small_data(), key,
                         mixing="metropolis_hastings_mixing", drop_prob=0.2,
                         probes=True, sentinels=True)
    jst, tst = start_pair(jsim, tsim, key)
    jst, tst, jrep, trep = run_pair(jsim, tsim, jst, tst, key, rounds=4)
    tp.assert_same_run(jsim, tsim, jst, tst, jrep, trep)
    seen = tp.assert_same_telemetry(jrep, trep)
    assert "health_mix_nonfinite" in seen
    assert (trep.probe_stale_hist[:, 1:] == 0).all()


# -- the topology generators' default backend ---------------------------------

def test_topology_default_backend_is_the_references():
    """The default call gives the JAX default's edge set below the native
    threshold and at and above it, where both take the native
    generator."""
    for n, d, seed in ((30, 4, 1), (101, 6, 3)):
        np.testing.assert_array_equal(
            tcore.Topology.random_regular(n, d, seed=seed).adjacency,
            np.asarray(jcore.Topology.random_regular(n, d, seed=seed)
                       .adjacency))
        np.testing.assert_array_equal(
            tcore.Topology.barabasi_albert(n, 3, seed=seed).adjacency,
            np.asarray(jcore.Topology.barabasi_albert(n, 3, seed=seed)
                       .adjacency))
    big = tcore.Topology.NATIVE_THRESHOLD
    assert big == jcore.Topology.NATIVE_THRESHOLD
    np.testing.assert_array_equal(
        tcore.Topology.random_regular(big, 4, seed=42).adjacency,
        np.asarray(jcore.Topology.random_regular(big, 4, seed=42).adjacency))
    np.testing.assert_array_equal(
        tcore.Topology.barabasi_albert(big, 3, seed=42).adjacency,
        np.asarray(jcore.Topology.barabasi_albert(big, 3, seed=42)
                   .adjacency))
    assert tcore.Topology.random_regular(
        big, 4, seed=42, backend="networkx").degrees.min() == 4
