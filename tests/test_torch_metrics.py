"""The port's metrics registry (``telemetry/metrics.py``, a copy of the JAX
module whose code ``test_torch_isolation.py`` pins to the original's) and
the engine's ``metrics=`` feed, held against the JAX package's.

- The same counters, gauges and histograms recorded in both registries
  give equal snapshots (timestamps aside), equal OpenMetrics text and
  equal quantiles; a snapshot of either merges with the other's, and
  loads into either registry alike.
- The same run in both engines under the JAX draw oracle, with
  ``metrics=True``, in one ``start`` or in chunks: the process registries'
  snapshots and OpenMetrics text equal, the JSONL ``metrics`` blocks
  equal and cumulative across ``start`` calls; ``metrics=`` off feeds
  nothing.
"""

import json

import jax
import numpy as np
import pytest

from gossipy_tpu.simulation.events import \
    JSONLinesReceiver as JJSONLinesReceiver
from gossipy_tpu.telemetry import metrics as jmetrics
from gossipy_tpu_torch.simulation.events import JSONLinesReceiver
from gossipy_tpu_torch.telemetry import metrics as tmetrics
from torch_pairs import clique_pair, to_port_state


@pytest.fixture
def regs():
    """A fresh process registry in each package."""
    j, t = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    pj, pt = jmetrics.set_registry(j), tmetrics.set_registry(t)
    yield j, t
    jmetrics.set_registry(pj)
    tmetrics.set_registry(pt)


def strip_ts(obj):
    """A snapshot without its wall-clock stamps."""
    if isinstance(obj, dict):
        return {k: strip_ts(v) for k, v in obj.items() if k != "ts"}
    if isinstance(obj, list):
        return [strip_ts(v) for v in obj]
    return obj


def record(mod, reg, seed):
    """Counters, a labelled gauge family, histograms with and without
    labels (values across the bucket range, a NaN, an overflowing label
    set) from ``seed``."""
    rng = np.random.default_rng(seed)
    c = reg.counter("engine_rounds_total", "rounds", ("simulator",))
    for i in range(5):
        c.labels(simulator=f"s{i % 2}").inc(float(rng.integers(1, 9)))
    g = reg.gauge("queue_depth", "queued", ("pool",))
    g.labels(pool="a").set_value(3.5)
    g.labels(pool="b").inc(2)
    g.labels(pool="b").dec(0.5)
    h = reg.histogram("round_seconds", "per-round latency", ("bucket",),
                      max_series=2)
    for v in np.exp(rng.normal(-4, 2, 200)):
        h.labels(bucket=f"b{int(v * 1e3) % 3}").observe(float(v))
    h.labels(bucket="b0").observe(float("nan"))
    plain = reg.histogram("plain_seconds", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 5.0, 50.0):
        plain.observe(v)
    return h


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_matches_jax(regs, seed):
    j, t = regs
    hj = record(jmetrics, j, seed)
    ht = record(tmetrics, t, seed)
    sj, st = j.snapshot(), t.snapshot()
    assert strip_ts(st) == strip_ts(sj)
    assert tmetrics.snapshot_to_openmetrics(st) == \
        jmetrics.snapshot_to_openmetrics(sj)
    assert t.to_openmetrics() == j.to_openmetrics()
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        for child_t, child_j in zip(ht.series(), hj.series()):
            assert child_t.quantile(q) == child_j.quantile(q)
    counts = [3, 0, 5, 1]
    for q in (0.1, 0.5, 0.95):
        assert tmetrics.quantile_from_counts((0.1, 1.0, 10.0), counts, q,
                                             lo=0.05, hi=20.0) == \
            jmetrics.quantile_from_counts((0.1, 1.0, 10.0), counts, q,
                                          lo=0.05, hi=20.0)
    assert tmetrics.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS
    assert tmetrics.METRICS_SCHEMA == jmetrics.METRICS_SCHEMA


def test_snapshots_cross_packages(regs):
    """A port snapshot and a JAX snapshot merge alike in either module,
    and each loads into the other's registry."""
    j, t = regs
    record(jmetrics, j, 3)
    record(tmetrics, t, 4)
    sj, st = j.snapshot(), t.snapshot()
    assert strip_ts(tmetrics.merge_snapshots(st, sj)) == \
        strip_ts(jmetrics.merge_snapshots(st, sj))
    assert strip_ts(tmetrics.merge_snapshots(st, sj)) == \
        strip_ts(tmetrics.merge_snapshots(sj, st))
    for snap in (sj, json.loads(json.dumps(st))):
        loaded_t, loaded_j = tmetrics.MetricsRegistry(), \
            jmetrics.MetricsRegistry()
        loaded_t.load_snapshot(snap)
        loaded_j.load_snapshot(snap)
        assert strip_ts(loaded_t.snapshot()) == strip_ts(loaded_j.snapshot())
        assert loaded_t.to_openmetrics() == loaded_j.to_openmetrics()
    with pytest.raises(ValueError):
        bad = json.loads(json.dumps(st))
        bad["metrics"]["engine_rounds_total"]["type"] = "gauge"
        tmetrics.merge_snapshots(st, bad)


def test_observe_engine_run_matches_jax(regs):
    j, t = regs
    for mod, reg in ((jmetrics, j), (tmetrics, t)):
        mod.observe_engine_run("GossipSimulator", 5, 60.0,
                               {"drop": 3.0, "offline": 2.0,
                                "overflow": 0.0})
        mod.observe_engine_run("GossipSimulator", 2, 24.0,
                               {"drop": 1.0, "offline": 0.0,
                                "overflow": 1.0})
    assert strip_ts(t.snapshot()) == strip_ts(j.snapshot())


@pytest.mark.parametrize("chunks", [(5,), (3, 2)])
def test_engine_feed_matches_jax(regs, chunks, tmp_path):
    """The same run in both engines with ``metrics=True`` (drops and
    offline receivers, so every cause counts), in one ``start`` or in
    two: equal registries, equal OpenMetrics, equal JSONL ``metrics``
    blocks, cumulative over the simulator's lifetime."""
    j, t = regs
    key = jax.random.PRNGKey(7)
    jsim, tsim = clique_pair(key, fused_merge="multi", metrics=True,
                             drop_prob=0.2, online_prob=0.8)
    jst = jsim.init_nodes(key)
    tst = to_port_state(tsim, jst)
    jpath, tpath = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    with JJSONLinesReceiver(jpath) as jrx, JSONLinesReceiver(tpath) as trx:
        jsim.add_receiver(jrx)
        tsim.add_receiver(trx)
        sent = failed = 0
        for n in chunks:
            jst, jrep = jsim.start(jst, n_rounds=n, key=key)
            tst, trep = tsim.start(tst, n_rounds=n)
            sent += trep.sent_messages
            failed += trep.failed_messages
    sj, st = j.snapshot(), t.snapshot()
    assert strip_ts(st) == strip_ts(sj)
    assert t.to_openmetrics() == j.to_openmetrics()
    trows = [JSONLinesReceiver.parse_line(l) for l in open(tpath)]
    jrows = [JJSONLinesReceiver.parse_line(l) for l in open(jpath)]
    assert [r["metrics"] for r in trows] == [r["metrics"] for r in jrows]
    assert [r["metrics"]["rounds_total"] for r in trows] == \
        list(range(1, sum(chunks) + 1))
    assert trows[-1]["metrics"]["sent_total"] == sent
    assert trows[-1]["metrics"]["failed_total"] == failed > 0
    series = st["metrics"]["engine_messages_failed_total"]["series"]
    by_cause = {r["labels"]["cause"]: r["value"] for r in series}
    assert sum(by_cause.values()) == failed
    assert by_cause["drop"] > 0 and by_cause["offline"] > 0
    assert tsim.run_manifest().to_dict()["config"]["metrics"] is True


def test_metrics_off_feeds_nothing(regs, tmp_path):
    _, t = regs
    key = jax.random.PRNGKey(7)
    _, tsim = clique_pair(key, fused_merge="multi")
    path = str(tmp_path / "t.jsonl")
    with JSONLinesReceiver(path) as rx:
        tsim.add_receiver(rx)
        tsim.start(tsim.init_nodes(), n_rounds=2)
    assert t.snapshot()["metrics"] == {}
    assert all(JSONLinesReceiver.parse_line(l)["metrics"] is None
               for l in open(path))
    assert tsim.run_manifest().to_dict()["config"]["metrics"] is False
