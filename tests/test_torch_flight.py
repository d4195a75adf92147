"""The event sink, host span tracing, the run manifest and the flight
recorder, held against the JAX package's.

- ``telemetry/sink.py`` and ``telemetry/tracing.py`` are the port's own
  copies of the JAX modules (standard library only; their code is pinned
  to the original's in ``test_torch_isolation.py``): on the same inputs
  they give the JAX module's results (event dicts, the JSONL mirror,
  ``merge_traces``, ``trace_report``). The pure parts of
  ``manifest.py`` (``_jsonable``, the config snapshot of the same
  configuration, the code-version block, the manifest's keys) agree too.
- The engine's ``tracing=`` spans: ``engine.start`` (a run window),
  ``engine.run`` (a wait) with one ``device.execute`` under it,
  ``engine.report``; none without ``tracing=``.
- ``FlightRecorder`` on a run with a NaN written into one node at a known
  round writes a bundle with the JAX bundle's files and verdict keys,
  from the last healthy state, with the JAX recorder's
  ``first_bad_round``, leaves, node and phase on the same run under the
  oracle; ``replay_bundle`` matches; the watchdog and exception bundles;
  with the ledger variable set, the bundle is a ledger row.
"""

import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gossipy_tpu import simulation as jsimulation
from gossipy_tpu.core import Topology as JTopology
from gossipy_tpu.handlers import SGDHandler, losses
from gossipy_tpu.models import LogisticRegression
from gossipy_tpu.telemetry import FlightRecorder as JFlightRecorder
from gossipy_tpu.telemetry import manifest as jmanifest
from gossipy_tpu.telemetry import replay_bundle as jreplay_bundle
from gossipy_tpu.telemetry import sink as jsink
from gossipy_tpu.telemetry import tracing as jtracing
from gossipy_tpu_torch import core as tcore
from gossipy_tpu_torch import simulation as tsimulation
from gossipy_tpu_torch.checkpoint import load_checkpoint_meta, \
    restore_checkpoint
from gossipy_tpu_torch.handlers import SGDHandler as TSGDHandler
from gossipy_tpu_torch.handlers import losses as tlosses
from gossipy_tpu_torch.models import LogisticRegression as TLogReg
from gossipy_tpu_torch.telemetry import FlightRecorder, manifest, \
    replay_bundle, sink, tracing
from torch_oracle import JaxDraws
from torch_pairs import small_data, to_port_state

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(1)

N, D = 12, 10
NAN_NODE, NAN_ROUND = 5, 3


def _sink_run(mod, path):
    s = mod.TelemetrySink(maxlen=3, jsonl_path=str(path))
    for i in range(5):
        s.emit("round" if i % 2 else "diag", {"round": i, "x": [i, 1.5]})
    out = {"events": [(e.kind, e.data) for e in s.events()],
           "rounds": [e.data for e in s.events(kind="round")],
           "where": [e.data for e in s.events(
               where=lambda e: e.data["round"] > 3)],
           "dropped": s.dropped_events}
    s.close()
    out["lines"] = [{k: v for k, v in json.loads(line).items() if k != "ts"}
                    for line in path.read_text().splitlines()]
    prev = mod.set_sink(mod.TelemetrySink())
    try:
        ev = mod.emit_event("k", {"a": 1})
        out["default"] = [e.to_dict()["data"] for e in
                          mod.get_sink().events()]
        assert sorted(ev.to_dict()) == ["data", "kind", "ts"]
    finally:
        mod.set_sink(prev)
    return out


def _strip_ts(obj):
    if isinstance(obj, dict):
        return {k: _strip_ts(v) for k, v in obj.items() if k != "ts"}
    if isinstance(obj, list):
        return [_strip_ts(v) for v in obj]
    return obj


def test_sink_matches_jax(tmp_path):
    """Each sink's ``close`` mirrors its package's process metrics
    registry into the file: with the same metrics recorded in both, the
    two files end with the same ``metrics_snapshot`` line (its stamps
    aside) after the same events."""
    from gossipy_tpu.telemetry import metrics as jmetrics
    from gossipy_tpu_torch.telemetry import metrics as tmetrics
    regs = (jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry())
    prev = (jmetrics.set_registry(regs[0]), tmetrics.set_registry(regs[1]))
    try:
        for reg in regs:
            reg.counter("engine_rounds_total", "rounds",
                        ("simulator",)).labels(simulator="s").inc(3)
            reg.histogram("round_seconds").observe(0.25)
        p = _sink_run(sink, tmp_path / "p.jsonl")
        j = _sink_run(jsink, tmp_path / "j.jsonl")
    finally:
        jmetrics.set_registry(prev[0])
        tmetrics.set_registry(prev[1])
    assert [line["kind"] for line in p["lines"]][-2:] == \
        ["metrics_snapshot", "sink_closed"]
    assert _strip_ts(p) == _strip_ts(j)


def _snapshot(mod, pid):
    """A fixed trace: a run window with a wait, a device span under it,
    host work and a counter, at given times."""
    tr = mod.Tracer(process_name=f"proc{pid}")
    tr.pid = pid
    t0 = 1000.0 * pid
    tr.add_complete("engine.start", t0, 100.0, cat="engine",
                    args={"round_start": 0, "rounds": 4})
    tr.add_complete("engine.run", t0 + 10, 70.0, cat=mod.WAIT_CAT)
    mod.attach_device_spans(tr, t0 + 10, 70.0, args={"n_rounds": 4})
    tr.add_complete("engine.report", t0 + 82, 15.0, cat="engine")
    tr.add_complete("checkpoint.save", t0 + 150, 30.0, cat="checkpoint")
    mod.attach_device_spans(tr, t0 + 200, 40.0,
                            phase_ms={"deliver": 3.0, "train": 1.0})
    tr.counter_event("queued", value=3)
    snap = tr.snapshot()
    for e in snap["traceEvents"]:
        e.pop("ts", None) if e.get("ph") == "C" else None
        if e.get("ph") == "M" and e.get("name") == "process_name":
            e["args"] = {"name": "proc"}
    return snap


def test_tracing_matches_jax():
    """``merge_traces`` and ``trace_report`` of the same snapshots, and
    the device spans laid by ``attach_device_spans``, equal the JAX
    module's; a port snapshot reduces the same in either module."""
    p = [_snapshot(tracing, i) for i in (1, 2)]
    j = [_snapshot(jtracing, i) for i in (1, 2)]
    assert p == j
    merged_p = tracing.merge_traces(p[0], p[1])
    merged_j = jtracing.merge_traces(j[0], j[1])
    assert merged_p == merged_j
    assert tracing.merge_traces(p[1], p[0]) == merged_p
    assert tracing.trace_report(merged_p) == jtracing.trace_report(merged_j)
    assert jtracing.trace_report(p[0]) == tracing.trace_report(p[0])
    with pytest.raises(ValueError):
        tracing.merge_traces(p[0], {"schema": 99})


def test_tracer_process_default():
    prev = tracing.set_tracer(None)
    try:
        with tracing.span("x") as sp:
            pass
        assert sp.duration is not None and sp.ts_us is None
        tr = tracing.ensure_tracer()
        assert tracing.ensure_tracer() is tr and tracing.get_tracer() is tr
        with tracing.span("y", cat="c", k=1):
            pass
        names = [e["name"] for e in tr.snapshot()["traceEvents"]
                 if e.get("ph") == "X"]
        assert names == ["y"]
    finally:
        tracing.set_tracer(prev)


def test_manifest_pure_parts_match_jax():
    value = {"a": np.int32(3), "b": np.float32(0.5), "c": np.arange(3),
             "d": (1, "x", None), 4: [np.float64(2.0)], "e": object}
    assert manifest._jsonable(value) == jmanifest._jsonable(value)
    assert manifest.code_version_block() == jmanifest.code_version_block()
    assert manifest.git_revision() == jmanifest.git_revision()
    assert manifest.MANIFEST_SCHEMA == jmanifest.MANIFEST_SCHEMA


def pair(key, sentinels=None, cls=(None, None), **kw):
    """12 LogReg nodes on ``random_regular(12, 4)`` in both packages, the
    port drawing from the oracle of ``key``."""
    jh = SGDHandler(model=LogisticRegression(D, 2),
                    loss=losses.cross_entropy, optimizer=optax.sgd(0.1),
                    local_epochs=1, batch_size=8, n_classes=2,
                    input_shape=(D,))
    th = TSGDHandler(TLogReg(D, 2), tlosses.cross_entropy,
                     learning_rate=0.1, local_epochs=1, batch_size=8,
                     n_classes=2, input_shape=(D,))
    topo = tcore.Topology.random_regular(N, 4, seed=5)
    data = small_data()
    jcls = cls[0] or jsimulation.GossipSimulator
    tcls = cls[1] or tsimulation.GossipSimulator
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsim = jcls(jh, JTopology(topo.adjacency), data, delta=100,
                    sentinels=sentinels, **kw)
        tsim = tcls(th, topo, data, delta=100, sentinels=sentinels,
                    draws=JaxDraws(key, init_key=key), device="cpu", **kw)
    return jsim, tsim


def test_manifest_config_snapshot_matches_jax(key):
    """The config snapshot of one configuration in both packages: the
    same keys and values (the partition-rule table included), and the
    manifest's keys."""
    jsim, tsim = pair(key, sentinels=True, fused_merge="multi")
    js = jmanifest._config_snapshot(jsim)
    ts = manifest._config_snapshot(tsim)
    assert sorted(js) == sorted(ts)
    assert ts.pop("partition_rules") == js.pop("partition_rules")
    assert json.loads(json.dumps(manifest._jsonable(ts))) == \
        json.loads(json.dumps(jmanifest._jsonable(js)))
    tm = tsim.run_manifest(extra={"k": 1}).to_dict()
    jm = jsim.run_manifest(extra={"k": 1}).to_dict()
    assert sorted(tm) == sorted(jm)
    assert tm["backend"]["backend"] == "cpu" and tm["mesh"] is None
    assert tm["memory_budget"] == tsim.memory_budget()
    assert tm["versions"]["torch"] == torch.__version__


def test_engine_tracing_spans(key):
    """``tracing=Tracer()``: each ``start`` is an ``engine.start`` run
    window (round_start, rounds) holding ``engine.run`` (a wait) with one
    ``device.execute`` span laid under it, then ``engine.report``; the
    manifest carries the trace's totals. ``tracing=True`` records into the
    process default; without ``tracing=`` nothing is recorded and the run
    is the same."""
    tr = tracing.Tracer()
    _, tsim = pair(key, tracing=tr)
    _, plain = pair(key)
    st = tsim.init_nodes(local_train=False)
    st2 = plain.init_nodes(local_train=False)
    st, rep = tsim.start(st, n_rounds=3)
    st, rep = tsim.start(st, n_rounds=2)
    st2, _ = plain.start(st2, n_rounds=5)
    assert torch.equal(st.model.params, st2.model.params)
    spans = [e for e in tr.snapshot()["traceEvents"] if e.get("ph") == "X"]
    names = [e["name"] for e in spans]
    assert sorted(names) == sorted(["engine.start", "device.execute",
                                    "engine.run", "engine.report"] * 2)
    starts = [e for e in spans if e["name"] == "engine.start"]
    assert [e["args"] for e in starts] == [{"round_start": 0, "rounds": 3},
                                           {"round_start": 3, "rounds": 2}]
    runs = [e for e in spans if e["name"] == "engine.run"]
    devs = [e for e in spans if e["name"] == "device.execute"]
    assert all(e["cat"] == tracing.WAIT_CAT for e in runs)
    for r, d, n in zip(runs, devs, (3, 2)):
        assert (d["ts"], d["dur"]) == (r["ts"], r["dur"])
        assert d["args"] == {"n_rounds": n}
        s = starts[n == 2]
        assert s["ts"] <= r["ts"] and r["ts"] + r["dur"] <= s["ts"] + s["dur"]
    report = tracing.trace_report(tr.snapshot())
    assert report["totals"]["rounds"] == 5
    assert tsim.run_manifest().to_dict()["trace"] == report["totals"]
    assert "engine.compile" not in names
    prev = tracing.set_tracer(None)
    try:
        _, t2 = pair(key, tracing=True)
        assert t2.tracer is tracing.get_tracer() is not None
        assert plain.tracer is None
    finally:
        tracing.set_tracer(prev)


# -- the flight recorder -----------------------------------------------------

class JPoisoned(jsimulation.GossipSimulator):
    """The JAX engine with a NaN written into node NAN_NODE's first bias
    entry before round NAN_ROUND's snapshot."""

    def _pre_send(self, state, base_key, r):
        p = state.model.params
        b = p["Dense_0"]["bias"]
        b = b.at[NAN_NODE, 0].set(jnp.where(r == NAN_ROUND, jnp.nan,
                                            b[NAN_NODE, 0]))
        params = {"Dense_0": {**p["Dense_0"], "bias": b}}
        return state._replace(model=state.model._replace(params=params))


class TPoisoned(tsimulation.GossipSimulator):
    """The port's engine with the same NaN (column 0 of the flat row is
    ``Dense_0/bias[0]``)."""

    def _pre_send(self, state, r):
        if r == NAN_ROUND:
            state.model.params[NAN_NODE, 0] = float("nan")


BUNDLE_FILES = ["checkpoint", "checkpoint.meta.json", "events.jsonl",
                "manifest.json", "verdict.json"]


def test_recorder_and_replay_match_jax(tmp_path, key):
    """The NaN written at round 3 mid-chunk (chunk 2: rounds 2-3): both
    recorders trip at round 3 and write the bundle of round 2, the last
    healthy state (finite, at round 2), with the same verdict; both
    replays name round 3, the leaf, the node and the phase (``send``: the
    NaN is in the params before the send phase)."""
    jsim, tsim = pair(key, sentinels=True, cls=(JPoisoned, TPoisoned),
                      fused_merge="multi")
    jst = jsim.init_nodes(key, local_train=False)
    tst = to_port_state(tsim, jst)
    jrec = JFlightRecorder(str(tmp_path / "jax"), chunk=2)
    _, jreps, jbundle = jrec.run(jsim, jst, n_rounds=8, key=key)
    trec = FlightRecorder(str(tmp_path / "port"), chunk=2)
    _, treps, tbundle = trec.run(tsim, tst, n_rounds=8)
    assert len(treps) == len(jreps) == 2
    jfiles = sorted(os.listdir(jbundle))
    assert sorted(os.listdir(tbundle)) == BUNDLE_FILES
    assert os.path.basename(tbundle) == os.path.basename(jbundle) == \
        "bundle_r000002_sentinel"
    assert set(jfiles) - {"checkpoint"} <= set(BUNDLE_FILES)
    jv = json.load(open(os.path.join(jbundle, "verdict.json")))
    tv = json.load(open(os.path.join(tbundle, "verdict.json")))
    assert sorted(tv) == sorted(jv)
    assert sorted(tv["detail"]) == sorted(jv["detail"])
    for k in ("bundle_version", "kind", "chunk_start_round",
              "first_bad_round"):
        assert tv[k] == jv[k], k
    assert tv["first_bad_round"] == NAN_ROUND
    for k in ("nonfinite_params_total", "nonfinite_leaves",
              "diverged_nodes"):
        assert tv["detail"][k] == jv["detail"][k], k
    meta = load_checkpoint_meta(os.path.join(tbundle, "checkpoint"))
    assert meta == {"bundle_version": 1, "kind": "sentinel", "round": 2}
    # The checkpoint is the chunk's start, not the tripped state.
    saved, draws = restore_checkpoint(os.path.join(tbundle, "checkpoint"),
                                      tsim.init_nodes(local_train=False))
    assert saved.round == 2 and draws is None
    assert bool(torch.isfinite(saved.model.params).all())
    tman = json.load(open(os.path.join(tbundle, "manifest.json")))
    jman = json.load(open(os.path.join(jbundle, "manifest.json")))
    assert sorted(tman) == sorted(jman)
    assert tman["extra"]["flight_recorder"] == \
        jman["extra"]["flight_recorder"]
    rounds = [json.loads(line) for line in
              open(os.path.join(tbundle, "events.jsonl"))]
    assert [r["data"]["round"] for r in rounds if r["kind"] == "round"][
        -4:] == [1, 2, 3, 4]

    _, tsim2 = pair(key, sentinels=True, cls=(JPoisoned, TPoisoned),
                    fused_merge="multi")
    jsim2, _ = pair(key, sentinels=True, cls=(JPoisoned, TPoisoned),
                    fused_merge="multi")
    tr = replay_bundle(tbundle, tsim2)
    jr = jreplay_bundle(jbundle, jsim2)
    assert tr == jr
    assert tr["matches_recorded"] is True and tr["first_bad_round"] == 3
    assert tr["leaf"] == "Dense_0/bias" and NAN_NODE in tr["nodes"]
    assert tr["phase"] == "send"


def test_replay_twin_records_and_matches(tmp_path):
    """The replay twin's demo under ``TorchDraws``: the data of one node
    is NaN, the bundle carries the draw state of its chunk's start, and a
    fresh simulator's replay matches, twice alike; ``--factory``."""
    from gossipy_tpu_torch.examples import replay_bundle as twin
    out = twin.main(["--record", str(tmp_path / "fr"), "--device", "cpu"])
    assert out["matches_recorded"] is True
    assert out["nodes"] == [twin.DEMO_POISON]
    bundle = [p for p in (tmp_path / "fr").iterdir()][0]
    again = twin.main([str(bundle), "--demo", "--device", "cpu"])
    assert again == out
    mods = tmp_path / "mods"
    mods.mkdir()
    (mods / "bundle_factory.py").write_text(
        "from gossipy_tpu_torch.examples.replay_bundle import demo_sim\n"
        "def build():\n    return demo_sim('cpu')\n")
    env = dict(os.environ, PYTHONPATH=f"{mods}{os.pathsep}{REPO}")
    proc = subprocess.run(
        [sys.executable, "-m", "gossipy_tpu_torch.examples.replay_bundle",
         str(bundle), "--factory", "bundle_factory:build"],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == out


def test_recorder_resumes_torch_draws(tmp_path):
    """Under ``TorchDraws`` a clean recorded run (chunks of 3) equals the
    straight run: the recorder clones the state and draw state at each
    chunk's start and changes nothing else."""
    from gossipy_tpu_torch.examples.replay_bundle import demo_sim
    a, b = demo_sim("cpu", poison=None), demo_sim("cpu", poison=None)
    sa = a.init_nodes(torch.Generator().manual_seed(1))
    sb = b.init_nodes(torch.Generator().manual_seed(1))
    sa, ra = a.start(sa, n_rounds=7)
    sb, rbs, bundle = FlightRecorder(str(tmp_path), chunk=3).run(b, sb, 7)
    assert bundle is None and len(rbs) == 3
    assert torch.equal(sa.model.params, sb.model.params)


def test_exception_writes_bundle_then_reraises(tmp_path):
    from gossipy_tpu_torch.examples.replay_bundle import demo_sim
    sim = demo_sim("cpu", poison=None)
    st = sim.init_nodes()
    original = sim.start
    calls = {"n": 0}

    def flaky_start(*a, **kw):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("card fell over")
        return original(*a, **kw)

    sim.start = flaky_start
    rec = FlightRecorder(str(tmp_path), chunk=2)
    with pytest.raises(RuntimeError, match="card fell over"):
        rec.run(sim, st, n_rounds=6)
    verdict = json.load(open(os.path.join(rec.bundle_path, "verdict.json")))
    assert verdict["kind"] == "exception"
    assert "card fell over" in verdict["detail"]["error"]
    assert verdict["chunk_start_round"] == 2


def test_watchdog_fires_on_stalled_chunk(tmp_path):
    from gossipy_tpu_torch.examples.replay_bundle import demo_sim
    sim = demo_sim("cpu", poison=None)
    st = sim.init_nodes()
    original = sim.start

    def slow_start(*a, **kw):
        time.sleep(0.6)
        return original(*a, **kw)

    sim.start = slow_start
    rec = FlightRecorder(str(tmp_path), chunk=4, watchdog_seconds=0.1)
    _, _, bundle = rec.run(sim, st, n_rounds=4)
    assert bundle is not None
    verdict = json.load(open(os.path.join(bundle, "verdict.json")))
    assert verdict["kind"] == "watchdog"
    assert verdict["detail"] == {"watchdog_seconds": 0.1}


def test_recorder_refusals(tmp_path, monkeypatch):
    """No sentinels: an assertion, as in the JAX recorder. The ledger
    variable set: the recorder runs and its bundle lands in the ledger
    as one failure row, beside the recorded simulator's engine rows."""
    from gossipy_tpu_torch.examples.replay_bundle import demo_sim
    from gossipy_tpu_torch.telemetry import RunLedger
    sim = demo_sim("cpu", poison=None)
    sim.sentinels = None
    with pytest.raises(AssertionError, match="sentinel-enabled"):
        FlightRecorder(str(tmp_path)).run(sim, sim.init_nodes(), 2)
    monkeypatch.setenv("GOSSIPY_TPU_LEDGER", str(tmp_path / "ledger"))
    sim = demo_sim("cpu")
    _, _, bundle = FlightRecorder(str(tmp_path)).run(sim, sim.init_nodes(),
                                                     2)
    rows = RunLedger(str(tmp_path / "ledger")).rows()
    bundles = [r for r in rows if r["kind"] == "bundle"]
    assert len(bundles) == 1 and bundle is not None
    assert bundles[0]["artifacts"]["bundle"]["path"] == bundle
    assert bundles[0]["failure"]["kind"] == "sentinel"
    assert all(r["kind"] == "engine" for r in rows if r not in bundles)


def test_trailing_window_truncation_warns_once(tmp_path):
    """A sink ring too small for the trailing window: the bundle says so
    in one warning."""
    from gossipy_tpu_torch.examples.replay_bundle import demo_sim
    prev = sink.set_sink(sink.TelemetrySink(maxlen=3))
    try:
        sim = demo_sim("cpu")
        st = sim.init_nodes(local_train=False)
        rec = FlightRecorder(str(tmp_path), chunk=4, trailing_rounds=16)
        with pytest.warns(UserWarning, match="trailing window truncated"):
            _, _, bundle = rec.run(sim, st, n_rounds=8)
        assert bundle is not None
    finally:
        sink.set_sink(prev)
