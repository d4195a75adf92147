"""The forensic twins: fused smoke, scale ladder, chaos and artifact
smokes, component microbenchmarks.

Each twin of a ``scripts/`` driver is held, on the host, to its JAX
script:

- the fused smoke's parity configuration (directed cycle, K = 4) runs
  in both engines under the JAX draw oracle, unfused and multi, on the
  fp32 and int8 rings, with equal accounting and params within 1e-5 (one
  encoding step more on int8); the twin's own gates pass (fp32 multi
  bit-equal to unfused, the launch property, the bytes-moved model);
- the ladder's smoke rungs have the JAX ladder's configuration (nodes,
  degree, rounds and the simulator's knobs); the 4-rung smoke ladder
  writes its rows, and ``--fail-at`` names the failing rung, its budget
  and the last healthy rung, and leaves its bundle;
- the chaos smoke's partition gap, the rounds it is open and
  ``rounds_to_reconverge`` equal the JAX smoke's under the oracle; the
  twin's checks pass;
- the artifact smoke writes and self-checks its artifacts, and a
  poisoned run trips and leaves its bundle;
- the component microbenchmark times every component at the smoke
  sizes, each median within its spread.
"""

import importlib.util
import json
import os
import sys
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_pairs
from gossipy_tpu.simulation import GossipSimulator as JGossipSimulator
from gossipy_tpu.simulation import \
    rounds_to_reconverge as j_rounds_to_reconverge
from gossipy_tpu_torch.examples import (chaos_smoke, ci_smoke_artifact,
                                        fused_smoke, microbench_components,
                                        scale_ladder)
from gossipy_tpu_torch.simulation import GossipSimulator, \
    rounds_to_reconverge
from torch_oracle import JaxDraws

REPO = Path(__file__).resolve().parents[1]

warnings.filterwarnings("ignore", message=r".*may overflow.*")


def jax_script(name: str):
    """A ``scripts/`` driver of the JAX package, loaded as a module."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_script_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the fused smoke ----------------------------------------------------------

@pytest.mark.parametrize("fused", [False, "multi"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_fused_parity_config_matches_jax_under_the_oracle(fused, dtype):
    jfs = jax_script("fused_smoke")
    key = jax.random.PRNGKey(0)
    jsim = jfs._parity_sim(fused, history_dtype=dtype)
    tsim = fused_smoke.parity_sim(fused, dtype, "cpu",
                                  draws=JaxDraws(key, init_key=key))
    assert (tsim.K, tsim.n_nodes) == (jsim.K, jsim.n_nodes) == (4, 12)
    trep = torch_pairs.run_both(jsim, tsim, key,
                                rounds=jfs.PARITY_ROUNDS, common_init=True)
    assert trep.sent_messages == 12 * jfs.PARITY_ROUNDS


def test_fused_smoke_gates_pass(tmp_path):
    out = tmp_path / "fused"
    assert fused_smoke.main(["--device", "cpu", "--out", str(out),
                             "--skip-ab"]) == 0
    report = json.loads((out / "fused_smoke.json").read_text())
    assert report["parity"]["float32"]["max_abs_diff"] == 0.0
    assert report["parity"]["int8"]["max_abs_diff"] <= 1e-6
    assert all(p["accounting_bit_equal"] for p in report["parity"].values())
    assert {k: v["got"] for k, v in report["launch"].items()} == {
        "engine/unfused": 0, "engine/fused-multi": 1,
        "engine/fused-compact": 1}
    assert {k: v["jax"] for k, v in report["launch"].items()} == {
        "engine/unfused": 0, "engine/fused-multi": 1,
        "engine/fused-compact": 2}


def test_fused_deliver_ab_row_and_ledger(tmp_path):
    """The A/B row's legs and its bytes-moved model (multi < per_slot <=
    plain); the row lands in the ledger. The deliver ms are a host-clock
    harness check here, not asserted."""
    report = {}
    failures = fused_smoke.check_deliver_ab(report, torch.device("cpu"),
                                            str(tmp_path), n=8)
    assert [f for f in failures if "bytes" in f or "missing" in f] == []
    raw = report["ab"]["raw"]
    assert set(raw["deliver_ms_per_round"]) == {"plain", "per_slot",
                                                "multi"}
    assert all(v > 0 for v in raw["deliver_ms_per_round"].values())
    dbm = raw["deliver_bytes_moved"]
    assert dbm["multi"] < dbm["per_slot"] <= dbm["plain"]
    from gossipy_tpu_torch.telemetry.ledger import (RunLedger,
                                                    ingest_bench_capsule)
    led = RunLedger(str(tmp_path / "l.jsonl"))
    ingest_bench_capsule(led, str(tmp_path / "fused_row.json"),
                         source="fused_smoke")
    assert len(led.rows()) == 1


# -- the scale ladder ---------------------------------------------------------

def test_ladder_rungs_have_the_jax_configuration():
    jsl = jax_script("scale_ladder")
    assert scale_ladder.DEFAULT_RUNGS == jsl.DEFAULT_RUNGS
    assert scale_ladder.SMOKE_RUNGS == jsl.SMOKE_RUNGS
    assert scale_ladder.COHORT_RUNGS == jsl.COHORT_RUNGS
    assert scale_ladder.SMOKE_COHORT_RUNGS == jsl.SMOKE_COHORT_RUNGS
    for n in jsl.SMOKE_RUNGS:
        cfg = scale_ladder.rung_config(n, smoke=True)
        # The JAX ladder's defaults with --smoke: 3 rounds, degree 4.
        assert (cfg["rounds"], cfg["degree"]) == (3, 4)
        jsim = jsl.build_rung_sim(n, cfg["degree"], cfg["rounds"])
        tsim = scale_ladder.build_rung_sim(n, cfg["degree"], cfg["rounds"],
                                           device="cpu")
        assert tsim.n_nodes == jsim.n_nodes == n
        assert np.array_equal(np.asarray(tsim.topology.degrees),
                              np.asarray(jsim.topology.degrees))
        for knob in ("delta", "sampling_eval", "eval_every",
                     "history_dtype"):
            assert getattr(tsim, knob) == getattr(jsim, knob), knob
        assert tsim.sentinels is not None and jsim.sentinels is not None
        assert tsim.perf is not None and jsim.perf is not None
        assert tsim.data["xtr"].shape == tuple(jsim.data["xtr"].shape)
        np.testing.assert_array_equal(tsim.data["xtr"].numpy(),
                                      np.asarray(jsim.data["xtr"]))
    full = scale_ladder.rung_config(100_000, smoke=False)
    assert (full["rounds"], full["degree"]) == (100, 20)


def test_smoke_ladder_writes_its_rows(tmp_path):
    out = tmp_path / "ladder"
    assert scale_ladder.main(["--smoke", "--device", "cpu", "--out",
                              str(out), "--ledger",
                              str(tmp_path / "l.jsonl")]) == 0
    ladder = json.loads((out / "ladder.json").read_text())
    assert [r["n_nodes"] for r in ladder["rungs"]] == [16, 24, 32, 48]
    assert ladder["verdict"] is None and ladder["rounds_per_rung"] == 3
    for i, row in enumerate(ladder["rungs"]):
        p, m = row["predicted"], row["measured"]
        assert p["total_bytes"] > 0 and p["flops_per_round"] > 0
        assert (p["ms_per_round"] is None) == (i == 0)
        assert m["ms_per_round"] > 0 and m["rounds_per_sec"] > 0
        # The timed run follows an untimed warm-up start of its length.
        assert row["warmup_rounds"] == 3
        # The port compiles nothing: the XLA fields are None; the host
        # run has no peak allocation.
        assert m["flops_per_round_xla"] is None and m["hbm_peak_bytes"] is None
    md = (out / "ladder.md").read_text()
    assert len([line for line in md.splitlines()
                if line.startswith("| ")]) == 5    # the header and 4 rungs
    assert "pred/meas memory" in md
    from gossipy_tpu_torch.telemetry.ledger import RunLedger
    assert len(RunLedger(str(tmp_path / "l.jsonl")).rows()) == 4


def test_fail_at_names_the_rung(tmp_path):
    out = tmp_path / "ladder"
    assert scale_ladder.main(["--smoke", "--device", "cpu", "--out",
                              str(out), "--fail-at", "24"]) == 1
    ladder = json.loads((out / "ladder.json").read_text())
    v = ladder["verdict"]
    assert v["failed_rung"] == 24 and v["last_healthy_rung"] == 16
    assert v["budget_bytes"] == ladder["rungs"][1]["predicted"][
        "total_bytes"] > 0
    assert v["program"] == "start[3r]" and "injected" in v["error"]
    assert os.path.isdir(v["bundle"]) and "rung_24" in v["bundle"]
    assert "**FAILED** at rung 24 (last healthy: 16)" in (
        out / "ladder.md").read_text()


def test_cohort_stream_ladder(tmp_path):
    out = tmp_path / "ladder"
    assert scale_ladder.main(["--smoke", "--cohort", "--stream", "--device",
                              "cpu", "--out", str(out), "--rungs",
                              "20000"]) == 0
    rows = json.loads((out / "ladder.json").read_text())["rungs"]
    assert [(r["nominal_n"], r["cohort_size"], r.get("prefetch"))
            for r in rows] == [(20000, 64, None), (20000, 64, 2)]
    assert rows[1]["stream_speedup"] > 0
    assert rows[0]["predicted"]["pool_resident_bytes"] > 0


def test_stream_needs_cohort(tmp_path):
    assert scale_ladder.main(["--stream", "--device", "cpu", "--out",
                              str(tmp_path)]) == 2


# -- the chaos smoke ----------------------------------------------------------

def test_chaos_gap_matches_jax_under_the_oracle():
    jcs = jax_script("chaos_smoke")
    key = jax.random.PRNGKey(11)
    jsim = jcs.build(JGossipSimulator)
    # The JAX smoke runs the JAX default (plain) deliver.
    tsim = chaos_smoke.build(GossipSimulator, "cpu",
                             draws=JaxDraws(key, init_key=key),
                             fused_merge=False)
    jst = jsim.init_nodes(key)
    tst = torch_pairs.to_port_state(tsim, jst)
    jst, jrep = jsim.start(jst, n_rounds=jcs.ROUNDS, key=key,
                           donate_state=False)
    tst, trep = tsim.start(tst, n_rounds=chaos_smoke.ROUNDS)
    jgap = np.asarray(jrep.chaos_component_gap, np.float64)
    tgap = np.asarray(trep.chaos_component_gap, np.float64)
    np.testing.assert_allclose(tgap, jgap, rtol=1e-5, atol=1e-6)
    assert (jcs.PART_START, jcs.PART_STOP) == (chaos_smoke.PART_START,
                                               chaos_smoke.PART_STOP)
    thresh = 1e-4
    assert list(np.flatnonzero(tgap > thresh)) == list(
        np.flatnonzero(jgap > thresh))
    jpeak = float(jgap[jcs.PART_START:jcs.PART_STOP].max())
    tpeak = float(tgap[chaos_smoke.PART_START:chaos_smoke.PART_STOP].max())
    jrec = j_rounds_to_reconverge(jgap, jcs.PART_STOP, tol=0.25 * jpeak)
    trec = rounds_to_reconverge(tgap, chaos_smoke.PART_STOP,
                                tol=0.25 * tpeak)
    # On the JAX smoke's own seed the gap stays above a quarter of its
    # peak after the heal (the JAX script's closing check fails there),
    # and the port reproduces that: both None.
    assert trec == jrec
    np.testing.assert_array_equal(trep.sent_per_round, jrep.sent_per_round)


def test_chaos_smoke_checks_pass(tmp_path):
    out = tmp_path / "chaos"
    assert chaos_smoke.main(["--device", "cpu", "--out", str(out)]) == 0
    verdict = json.loads((out / "chaos_verdict.json").read_text())
    assert verdict["ok"] and all(c["ok"] for c in verdict["checks"].values())
    assert set(verdict["checks"]) == {
        "gap_opens_during_partition", "gap_closes_after_heal",
        "reconverges_within_report", "chunked_resume_bit_identical",
        "sequential_gap_opens_and_closes"}
    assert "chaos" in verdict["failed_by_cause_keys"]
    assert (out / "report.json").is_file()
    rows = [json.loads(line) for line in open(out / "events.jsonl")]
    assert len(rows) == chaos_smoke.ROUNDS and rows[4]["chaos"] is not None


# -- the artifact smoke -------------------------------------------------------

def test_artifact_smoke_writes_and_checks(tmp_path):
    out = ci_smoke_artifact.main(["--device", "cpu", "--out",
                                  str(tmp_path)])
    assert out["sentinel_trips"] == 0 and out["accepted_merges"] > 0
    for name in ("report.json", "manifest.json", "events.jsonl"):
        assert (tmp_path / name).is_file(), name
    assert not [d for d in os.listdir(tmp_path) if d.startswith("bundle_")]


def test_artifact_smoke_trip_leaves_a_bundle(tmp_path):
    with pytest.raises(SystemExit) as exc:
        ci_smoke_artifact.main(["--device", "cpu", "--out", str(tmp_path),
                                "--poison", "3"])
    assert exc.value.code == 2
    bundles = [d for d in os.listdir(tmp_path) if d.startswith("bundle_")]
    assert len(bundles) == 1 and "sentinel" in bundles[0]
    assert (tmp_path / "report.json").is_file()


def test_artifact_smoke_config_is_the_jax_one():
    jca = jax_script("ci_smoke_artifact")
    jsim = jca.build_smoke_sim(16)
    tsim = ci_smoke_artifact.build_smoke_sim(16, device="cpu")
    np.testing.assert_array_equal(tsim.data["xtr"].numpy(),
                                  np.asarray(jsim.data["xtr"]))
    np.testing.assert_array_equal(np.asarray(tsim.topology.degrees),
                                  np.asarray(jsim.topology.degrees))
    assert (tsim.delta, tsim.n_nodes) == (jsim.delta, jsim.n_nodes)


# -- the component microbenchmarks --------------------------------------------

def test_microbench_times_every_component(capsys):
    out = microbench_components.main(["--small", "--device", "cpu",
                                      "--reps", "1"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == out
    comp = out["components"]
    jmb = (REPO / "scripts" / "microbench_components.py").read_text()
    for key in comp:
        assert f'"{key}"' in jmb, key
    assert comp["eval_vmap_alt_ms"] is None and comp["train_slot_alt_ms"] \
        is None
    timed = {k: v for k, v in comp.items()
             if k.endswith("_ms") and v is not None}
    assert len(timed) == 7 and all(v > 0 for v in timed.values())
    assert (out["n_nodes"], out["n_eval_nodes"], out["eval_set"],
            out["shard"]) == (8, 2, 64, 32)
    # Each timed component's median call lies within its spread.
    assert set(out["spread_ms"]) == {k[:-3] for k in timed}
    for k, (lo, hi) in out["spread_ms"].items():
        assert 0 < lo <= comp[f"{k}_ms"] <= hi


# -- the twins with the JAX modules blocked -----------------------------------

BANNED = ("jax", "jaxlib", "flax", "optax", "chex", "gossipy_tpu",
          "networkx", "sklearn")

# Each new twin at a host size: (module, arguments); each exits 0.
BLOCKED_TWINS = {
    "program_gate": [],
    "fused_smoke": ["--skip-ab"],
    "scale_ladder": ["--smoke", "--rungs", "16,24"],
    "chaos_smoke": [],
    "ci_smoke_artifact": [],
    "microbench_components": ["--small", "--reps", "1"],
    "baseline": ["--rounds", "1"],
}


@pytest.mark.parametrize("twin", sorted(BLOCKED_TWINS))
def test_twin_runs_with_jax_blocked(twin, tmp_path):
    import subprocess
    args = BLOCKED_TWINS[twin] + ["--device", "cpu"]
    if twin not in ("program_gate", "microbench_components", "baseline"):
        args += ["--out", str(tmp_path / "out")]
    code = (
        "import sys, socket, warnings\n"
        f"for m in {BANNED!r}:\n"
        "    sys.modules[m] = None\n"
        "class NoNet(socket.socket):\n"
        "    def connect(self, *a):\n"
        "        raise OSError('no network')\n"
        "socket.socket = NoNet\n"
        "warnings.simplefilter('ignore')\n"
        f"import gossipy_tpu_torch.examples.{twin} as twin\n"
        f"rc = twin.main({args!r})\n"
        "sys.exit(rc if isinstance(rc, int) else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("GOSSIPY_TPU_LEDGER", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
