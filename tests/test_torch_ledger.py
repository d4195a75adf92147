"""The run ledger (``telemetry/ledger.py``, a copy of the JAX module whose
code ``test_torch_isolation.py`` pins to the original's), the engine's
``ledger=``, the flight recorder's bundle row and the ledger CLI twin,
held against the JAX package's.

- A ledger file written by the port's ``RunLedger`` reads in the JAX
  package's and the other way round; a torn tail is skipped on read and
  repaired by the next append; ledgers merge alike in both modules.
- The same run in both engines with ``ledger=`` (and ``perf=``, so the
  rows carry their rounds/s): one row a ``start`` under one run id, the
  same row keys, config and headline metrics (the final accuracy within
  the north star's path tolerance, 1e-5), the same config fingerprint.
- ``FlightRecorder`` with ``GOSSIPY_TPU_LEDGER`` set appends one bundle
  row shaped like the JAX recorder's.
- ``gossipy_tpu_torch.examples.ledger`` (the twin of ``scripts/
  ledger.py``): list, show, diff (the changed field and the first
  divergent round from linked reports), trend, merge and bisect over
  the port's ``run_experiment``.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest

from gossipy_tpu.telemetry import FlightRecorder as JFlightRecorder
from gossipy_tpu.telemetry import ledger as jledger
from gossipy_tpu_torch.examples import ledger as ledger_cli
from gossipy_tpu_torch.telemetry import FlightRecorder, RunLedger
from gossipy_tpu_torch.telemetry import ledger as tledger
from torch_pairs import clique_pair, small_data, to_port_state

ROWS = [{"kind": "engine", "run_id": "a1", "ts": 1.0,
         "config": {"n_nodes": 8, "drop_prob": 0.0, "tracing": True},
         "metrics": {"rounds_per_sec": 10.5, "final_accuracy": 0.9}},
        {"kind": "bench", "ts": 2.0, "backend": "cpu",
         "metrics": {"rounds_per_sec": 9.0}},
        {"kind": "bundle", "ts": 3.0, "failure": {"kind": "sentinel"}}]


@pytest.mark.parametrize("writer,reader", [(tledger, jledger),
                                           (jledger, tledger)])
def test_ledger_file_reads_in_the_other_package(writer, reader, tmp_path):
    path = str(tmp_path / "l.jsonl")
    led = writer.RunLedger(path)
    stamped = [led.append(r) for r in ROWS]
    got = reader.RunLedger(path).read()
    assert got["skipped"] == 0
    assert got["rows"] == json.loads(json.dumps(stamped))
    assert reader.RunLedger(path).find("a1") == [got["rows"][0]]


@pytest.mark.parametrize("mod", [tledger, jledger])
def test_torn_tail_skipped_then_repaired(mod, tmp_path):
    """A record cut mid-append (no newline) is skipped by both readers;
    the next append of either package truncates it and lands whole."""
    path = str(tmp_path / "l.jsonl")
    tledger.RunLedger(path).append(ROWS[0])
    with open(path, "ab") as fh:
        fh.write(b'0badc0de {"kind": "torn"')
    for m in (tledger, jledger):
        doc = m.RunLedger(path).read()
        assert (len(doc["rows"]), doc["skipped"]) == (1, 1)
    mod.RunLedger(path).append(ROWS[1])
    for m in (tledger, jledger):
        doc = m.RunLedger(path).read()
        assert (len(doc["rows"]), doc["skipped"]) == (2, 0)
    # A corrupt byte inside a complete line is skipped, never fatal.
    raw = open(path, "rb").read().split(b"\n")
    raw[0] = raw[0][:20] + b"X" + raw[0][21:]
    open(path, "wb").write(b"\n".join(raw))
    assert tledger.RunLedger(path).read()["skipped"] == 1


def test_merge_and_fingerprint_match_jax(tmp_path):
    a = [tledger.RunLedger(str(tmp_path / "a")).append(r) for r in ROWS[:2]]
    b = [jledger.RunLedger(str(tmp_path / "b")).append(r) for r in ROWS[1:]]
    assert tledger.merge_ledgers(a, b) == jledger.merge_ledgers(a, b)
    assert tledger.merge_ledgers(a, b) == tledger.merge_ledgers(b, a)
    assert tledger.merge_ledgers(a, a) == tledger.merge_ledgers([], a)
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    assert tledger.merge_ledger_files(out_t, [str(tmp_path / "a"),
                                              str(tmp_path / "b")]) == 4
    jledger.merge_ledger_files(out_j, [str(tmp_path / "a"),
                                       str(tmp_path / "b")])
    assert open(out_t).read() == open(out_j).read()
    with pytest.raises(ValueError):
        tledger.merge_ledgers(a, [dict(b[0], schema=99)])
    for cfg in (ROWS[0]["config"], {"n_nodes": 8, "perf": {"cost": True}},
                {"x": np.int32(3), "y": [np.float32(0.5)]}, None):
        assert tledger.config_fingerprint(cfg) == \
            jledger.config_fingerprint(cfg)
    man = {"perf": {"last_run": {"mfu_est": 0.25}},
           "trace": {"host_blocked_frac": 0.5, "overlap_frac": 0.1},
           "extra": {"service": {"slo": {"bucket_round_seconds_p50": 0.1,
                                         "bucket_round_seconds_p99": 1.0}}}}
    assert tledger.headline_from_manifest(man) == \
        jledger.headline_from_manifest(man)
    for name in ("HEADLINE_METRICS", "LEDGER_ENV", "LEDGER_SCHEMA"):
        assert getattr(tledger, name) == getattr(jledger, name)


def test_adapters_match_jax(tmp_path):
    """The bench, trace, SLO and ladder adapters give the JAX adapters'
    rows on the same inputs (run ids, stamps and paths aside)."""
    capsule = {"n": 3, "parsed": {"metric": "rounds_per_sec",
                                  "value": 30.5, "raw": {
                                      "backend": "gpu", "n_nodes": 100,
                                      "host_blocked_frac": 0.2}}}
    report = {"n_windows": 2, "totals": {"host_blocked_frac": 0.3,
                                         "overlap_frac": 0.4,
                                         "wall_ms": 12.0}}
    slo = {"metric": "service_slo", "value": 9.0,
           "raw": {"ttfr_p50_ms": 3.0, "n_admitted": 4}}
    ladder = {"backend": "gpu", "rungs": [
        {"n_nodes": 1000, "measured": {"ms_per_round": 8.0}},
        {"n_nodes": 2000, "failed": True, "measured": {}}],
        "verdict": {"rung": 2}}
    out = {}
    for m in (tledger, jledger):
        led = m.RunLedger(str(tmp_path / f"{m.__name__}.jsonl"))
        rows = [m.ingest_bench_capsule(led, capsule),
                m.ingest_trace_report(led, report),
                m.ingest_slo_row(led, slo)] + m.ingest_ladder(led, ladder)
        out[m] = [{k: v for k, v in r.items()
                   if k not in ("run_id", "ts", "code_version")}
                  for r in rows]
    assert out[tledger] == out[jledger]


def test_engine_rows_match_jax(tmp_path):
    """The same run, 3 + 2 rounds, in both engines with ``ledger=`` and
    ``perf=``: two rows each under one run id, the same keys, kind,
    config (the snapshot) and fingerprint, the same headline keys, the
    final accuracy within 1e-5, the segments' rounds."""
    key = jax.random.PRNGKey(3)
    jpath, tpath = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    jsim, _ = clique_pair(key, fused_merge="multi", ledger=jpath,
                          perf=True)
    _, tsim = clique_pair(key, fused_merge="multi", ledger=tpath,
                          perf=True)
    jst = jsim.init_nodes(key)
    tst = to_port_state(tsim, jst)
    for n in (3, 2):
        jst, _ = jsim.start(jst, n_rounds=n, key=key)
        tst, _ = tsim.start(tst, n_rounds=n)
    jrows, trows = RunLedger(jpath).rows(), RunLedger(tpath).rows()
    assert len(trows) == len(jrows) == 2
    assert len({r["run_id"] for r in trows}) == 1
    for t, j in zip(trows, jrows):
        assert sorted(t) == sorted(j)
        assert t["kind"] == j["kind"] == "engine"
        assert t["extra"] == j["extra"]
        assert t["config"] == j["config"]
        assert t["config_fingerprint"] == j["config_fingerprint"]
        assert t["backend"] == j["backend"] == "cpu"
        assert t["degraded"] is j["degraded"] is True
        assert sorted(t["metrics"]) == sorted(j["metrics"])
        assert t["metrics"]["final_accuracy"] == pytest.approx(
            j["metrics"]["final_accuracy"], abs=1e-5)
        assert t["metrics"]["rounds_per_sec"] > 0
        assert sorted(t["artifacts"]) == sorted(j["artifacts"])
    assert [r["extra"]["rounds"] for r in trows] == [3, 2]


def test_engine_ledger_off_and_env(tmp_path, monkeypatch):
    """``ledger=None`` consults ``GOSSIPY_TPU_LEDGER``; ``False`` is off
    whatever it says; without perf or tracing a row carries no rounds/s
    (the run's end was not synchronised)."""
    key = jax.random.PRNGKey(3)
    path = str(tmp_path / "env.jsonl")
    monkeypatch.setenv("GOSSIPY_TPU_LEDGER", path)
    _, on = clique_pair(key)
    _, off = clique_pair(key, ledger=False)
    on.start(on.init_nodes(), n_rounds=2)
    off.start(off.init_nodes(), n_rounds=2)
    rows = RunLedger(path).rows()
    assert len(rows) == 1 and "rounds_per_sec" not in rows[0]["metrics"]
    assert rows[0]["config"]["ledger"] is True
    assert on.run_manifest().to_dict()["config"]["ledger"] is True
    assert off.run_manifest().to_dict()["config"]["ledger"] is False


class _TPoisoned:
    """Mixin: a NaN written into node 5's first bias entry before round
    3's snapshot."""

    def _pre_send(self, state, r):
        if r == 3:
            state.model.params[5, 0] = float("nan")


def test_recorder_bundle_row_matches_jax(tmp_path, monkeypatch):
    """Both recorders under ``GOSSIPY_TPU_LEDGER``: one bundle row each,
    the same keys, failure kind and verdict, the bundle and its verdict
    as artifacts; the port's recorded simulator adds its engine rows."""
    import jax.numpy as jnp

    from gossipy_tpu import simulation as jsimulation
    from gossipy_tpu_torch import simulation as tsimulation

    class JPoisoned(jsimulation.GossipSimulator):
        def _pre_send(self, state, base_key, r):
            p = state.model.params
            b = p["Dense_0"]["bias"]
            b = b.at[5, 0].set(jnp.where(r == 3, jnp.nan, b[5, 0]))
            params = {"Dense_0": {**p["Dense_0"], "bias": b}}
            return state._replace(model=state.model._replace(params=params))

    class TPoisoned(_TPoisoned, tsimulation.GossipSimulator):
        pass

    key = jax.random.PRNGKey(5)
    rows = {}
    for side in ("jax", "port"):
        path = str(tmp_path / f"{side}.jsonl")
        monkeypatch.setenv("GOSSIPY_TPU_LEDGER", path)
        jsim, tsim = _poisoned_pair(key, JPoisoned, TPoisoned)
        jst = jsim.init_nodes(key, local_train=False)
        if side == "jax":
            JFlightRecorder(str(tmp_path / side), chunk=2).run(
                jsim, jst, n_rounds=6, key=key)
        else:
            FlightRecorder(str(tmp_path / side), chunk=2).run(
                tsim, to_port_state(tsim, jst), n_rounds=6)
        rows[side] = RunLedger(path).rows()
    jb = [r for r in rows["jax"] if r["kind"] == "bundle"]
    tb = [r for r in rows["port"] if r["kind"] == "bundle"]
    assert len(tb) == len(jb) == 1
    t, j = tb[0], jb[0]
    assert sorted(t) == sorted(j)
    assert t["failure"]["kind"] == j["failure"]["kind"] == "sentinel"
    for k in ("bundle_version", "kind", "chunk_start_round",
              "first_bad_round"):
        assert t["failure"]["verdict"][k] == j["failure"]["verdict"][k], k
    assert sorted(t["artifacts"]) == sorted(j["artifacts"]) == \
        ["bundle", "verdict"]
    assert os.path.basename(t["artifacts"]["bundle"]["path"]) == \
        os.path.basename(j["artifacts"]["bundle"]["path"])
    assert t["artifacts"]["verdict"]["sha256"]
    # The snapshot names each side's own (poisoned) simulator class.
    assert {**t["config"], "simulator": None} == \
        {**j["config"], "simulator": None}
    engine = [r for r in rows["port"] if r["kind"] == "engine"]
    assert len(engine) == 2 and len({r["run_id"] for r in engine}) == 1


def _poisoned_pair(key, jcls, tcls):
    import warnings

    import optax

    from gossipy_tpu.core import Topology as JTopology
    from gossipy_tpu.handlers import SGDHandler, losses
    from gossipy_tpu.models import LogisticRegression
    from gossipy_tpu_torch import core as tcore
    from gossipy_tpu_torch.handlers import SGDHandler as TSGDHandler
    from gossipy_tpu_torch.handlers import losses as tlosses
    from gossipy_tpu_torch.models import LogisticRegression as TLogReg
    from torch_oracle import JaxDraws
    jh = SGDHandler(model=LogisticRegression(10, 2),
                    loss=losses.cross_entropy, optimizer=optax.sgd(0.1),
                    local_epochs=1, batch_size=8, n_classes=2,
                    input_shape=(10,))
    th = TSGDHandler(TLogReg(10, 2), tlosses.cross_entropy,
                     learning_rate=0.1, local_epochs=1, batch_size=8,
                     n_classes=2, input_shape=(10,))
    topo = tcore.Topology.random_regular(12, 4, seed=5)
    data = small_data()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsim = jcls(jh, JTopology(topo.adjacency), data, delta=100,
                    sentinels=True, fused_merge="multi")
        tsim = tcls(th, topo, data, delta=100, sentinels=True,
                    fused_merge="multi", draws=JaxDraws(key, init_key=key),
                    device="cpu")
    return jsim, tsim


# -- the CLI twin ------------------------------------------------------------

def _cfg(**changes):
    from gossipy_tpu_torch.config import ExperimentConfig
    return dataclasses.replace(
        ExperimentConfig(dataset="spambase", subsample=480, n_nodes=8,
                         topology="ring", topology_params={"k": 2},
                         delta=10, batch_size=8, learning_rate=0.5,
                         n_rounds=8), **changes)


@pytest.fixture(scope="module")
def forensic(tmp_path_factory):
    """Two port runs differing in one config field (drop_prob), their
    reports saved as linked artifacts; a pinned experiment on each."""
    import warnings

    from gossipy_tpu_torch.config import run_experiment
    out = tmp_path_factory.mktemp("forensic")
    led = RunLedger(str(out / "ledger.jsonl"))
    accs = {}
    for name, cfg in (("a", _cfg()), ("b", _cfg(drop_prob=0.5))):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, report = run_experiment(cfg, device="cpu")
        rpath = str(out / f"report_{name}.json")
        report.save(rpath)
        accs[name] = float(report.final("accuracy"))
        tledger.ingest_manifest(
            led, {"config": dataclasses.asdict(cfg),
                  "backend": {"backend": "cpu", "device_kind": "cpu"}},
            run_id=f"run{name * 3}000",
            metrics={"final_accuracy": accs[name]},
            artifacts={"report": rpath},
            experiment=dataclasses.asdict(cfg))
    led.append({"kind": "engine", "run_id": "noexp0000000",
                "metrics": {"final_accuracy": 0.9}})
    bad = dataclasses.asdict(_cfg(learning_rate=0.0))
    led.append({"kind": "engine", "run_id": "bad000000000",
                "experiment": bad})
    return {"path": led.path, "accs": accs}


def test_cli_list_show_diff(forensic, tmp_path, capsys):
    out = str(tmp_path / "list.md")
    assert ledger_cli.main(["list", forensic["path"], "--out", out]) == 0
    text = open(out).read()
    assert "| run id |" in text and "runaaa000" in text
    assert "4 row(s)" in text
    assert ledger_cli.main(["list", forensic["path"], "--json",
                            "--config", "drop_prob=0.5", "--out", out]) == 0
    assert [r["run_id"] for r in json.load(open(out))] == ["runbbb000"]
    assert ledger_cli.main(["show", forensic["path"], "runaaa"]) == 0
    assert json.loads(capsys.readouterr().out)["run_id"] == "runaaa000"
    with pytest.raises(SystemExit, match="no row"):
        ledger_cli.main(["show", forensic["path"], "nope"])
    rows = RunLedger(forensic["path"]).rows()
    d = ledger_cli.diff_rows(rows[0], rows[1])
    assert d["config_diff"] == {"drop_prob": {"a": 0.0, "b": 0.5}}
    assert d["fingerprint_changed"] is True
    acc = d["metric_deltas"]["final_accuracy"]
    assert acc["delta"] == pytest.approx(forensic["accs"]["b"]
                                         - forensic["accs"]["a"])
    assert 1 <= d["first_divergent_round"] <= 8
    assert ledger_cli.main(["diff", forensic["path"], "@0", "@1",
                            "--expect-config-diff"]) == 0
    assert "drop_prob: 0.0 -> 0.5" in capsys.readouterr().out


def test_cli_trend_and_merge(forensic, tmp_path):
    led = RunLedger(str(tmp_path / "t.jsonl"))
    for v, ts in ((100.0, 1.0), (45.0, 2.0)):
        led.append({"kind": "bench", "ts": ts, "backend": "cpu",
                    "metrics": {"rounds_per_sec": v}})
    assert ledger_cli.main(["trend", led.path, "--metric",
                            "rounds_per_sec"]) == 1
    led2 = RunLedger(str(tmp_path / "ok.jsonl"))
    for v, ts in ((100.0, 1.0), (90.0, 2.0)):
        led2.append({"kind": "bench", "ts": ts, "backend": "cpu",
                     "metrics": {"rounds_per_sec": v}})
    assert ledger_cli.main(["trend", led2.path, "--metric",
                            "rounds_per_sec"]) == 0
    out = str(tmp_path / "merged.jsonl")
    assert ledger_cli.main(["merge", out, forensic["path"], led2.path]) == 0
    assert len(RunLedger(out).rows()) == 6


def test_cli_bisect_exit_codes(forensic, capsys):
    """The pinned good config replays within tolerance (0), the
    no-learning one below it (1); rows without an experiment or a
    recorded metric skip (125)."""
    base = ["--baseline", "runaaa", "--metric", "final_accuracy",
            "--device", "cpu"]
    assert ledger_cli.main(["bisect", forensic["path"], "runaaa"]
                           + base) == 0
    assert json.loads(capsys.readouterr().out)["verdict"] == "good"
    assert ledger_cli.main(["bisect", forensic["path"], "bad"] + base) == 1
    assert json.loads(capsys.readouterr().out)["verdict"] == "BAD"
    assert ledger_cli.main(["bisect", forensic["path"], "noexp"]
                           + base) == 125
    assert ledger_cli.main(["bisect", forensic["path"], "runaaa",
                            "--baseline", "noexp", "--metric",
                            "rounds_per_sec", "--device", "cpu"]) == 125
