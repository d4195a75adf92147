"""Self-forensic scale ladder: predicted against measured cost per N rung.

Twin of ``scripts/scale_ladder.py``. Walks an N ladder (default 1,000 ->
2,000 -> 5,000 -> 10,000 -> 20,000 -> 50,000 -> 100,000) of
``examples/scale.py``'s vanilla row (``SparseTopology`` CSR, LogReg SGD,
PUSH, a 1% sampled eval on the last round, the default single-pass fused
deliver: K1 once a round with messages on the card) and records, per
rung:

- **predicted**: ``memory_budget()`` (the construction-time budget),
  ``telemetry.analytic_round_cost``'s FLOPs a round, and a time linear in
  N from the previous measured rung;
- **measured**: ms/round, rounds/s and ``mfu_est`` (the engine's
  ``perf=`` timing of the flight-recorded run, which follows an untimed
  warm-up ``start`` of the same length, so the first round's lazy
  tables and the kernels' first launches stay out of it; the window
  keeps its last round's eval, as every run of the row does), and the
  peak allocation of the run
  (``torch.cuda.max_memory_allocated``, banked in the run's
  ``CostReport``; None on the host). The JAX ladder's XLA fields
  (``flops_per_round_xla``, ``bytes_per_round_xla``, ``temp_bytes``,
  ``compile_seconds``) are None, as in the port's ``perf``.

``memory_budget`` is not corrected here: the gap between the peak and
the budget is recorded (``memory_predicted_over_measured``).

Every rung runs under :class:`~gossipy_tpu_torch.telemetry.FlightRecorder`
with sentinels on: a failing rung leaves a repro bundle and a verdict
naming the failing rung, its banked budget and peak, and the last healthy
rung. ``--fail-at N`` injects a fault into rung N after its simulator is
built, during the run (the perf layer's post-run timing call raises, as
an allocator failure would), so the verdict path is exercised.

``--cohort`` climbs NOMINAL populations (1,000,000 and 10,000,000; smoke
20,000 and 50,000) at a fixed materialized cohort C (``--cohort-size``,
default 1024; 64 with ``--smoke``) over a ``NominalTopology``;
``--stream`` runs each cohort rung as a serial and a ``--prefetch``
streaming pair, the streaming row carrying ``stream_speedup``.

Artifacts (``--out DIR``): ``ladder.json`` (``{"rungs": [...],
"verdict": {...} | null}``), ``ladder.md`` (the markdown rows) and
``rung_<N>/bundle_*/`` of a failed rung; ``--ledger`` appends one digest
row a rung (and a failure row) to the run ledger.

    python3 -m gossipy_tpu_torch.examples.scale_ladder              # card
    python3 -m gossipy_tpu_torch.examples.scale_ladder --smoke --device cpu
    python3 -m gossipy_tpu_torch.examples.scale_ladder --smoke --fail-at 24 \\
        --device cpu

Exit codes: 0 clean ladder, 1 a rung failed (verdict written), 2 usage.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from gossipy_tpu_torch import resolve_device, set_seed
from gossipy_tpu_torch.core import AntiEntropyProtocol, SparseTopology
from gossipy_tpu_torch.data import ClassificationDataHandler, DataDispatcher
from gossipy_tpu_torch.examples import scale
from gossipy_tpu_torch.random import TorchDraws

DEFAULT_RUNGS = (1_000, 2_000, 5_000, 10_000, 20_000, 50_000, 100_000)
SMOKE_RUNGS = (16, 24, 32, 48)
COHORT_RUNGS = (1_000_000, 10_000_000)
SMOKE_COHORT_RUNGS = (20_000, 50_000)


def rung_config(n_nodes: int, smoke: bool, rounds=None, degree=None) -> dict:
    """A rung's (nodes, degree, rounds), as the JAX ladder derives them."""
    rounds = rounds or (3 if smoke else 100)
    degree = degree or (4 if smoke else 20)
    return {"n_nodes": n_nodes, "degree": min(degree, n_nodes - 1),
            "rounds": rounds}


def build_rung_sim(n_nodes: int, degree: int, rounds: int,
                   history_dtype: str = "float32", device=None):
    """One rung's simulator: the scale twin's vanilla row at ``n_nodes``
    with sentinels (the flight recorder's contract) and ``perf=`` (the
    timing and the cost banking) on."""
    topo = SparseTopology.random_regular(n_nodes, min(degree, n_nodes - 1),
                                         seed=42)
    sim = scale.GossipSimulator(
        scale.scale_handler(), topo, scale.scale_data(n_nodes),
        delta=scale.ROUND_LEN, protocol=AntiEntropyProtocol.PUSH,
        sampling_eval=0.01, eval_every=rounds, history_dtype=history_dtype,
        draws=TorchDraws(42), device=device, sentinels=True, perf=True)
    return sim


def build_cohort_rung_sim(nominal_n: int, cohort_size: int, rounds: int,
                          history_dtype: str = "float32",
                          prefetch: int = 0, device=None):
    """A cohort rung's simulator: the same LogReg round at a fixed
    materialized cohort C over a nominal population (``NominalTopology``:
    no O(N) graph). The data bank is ``4 C`` shards; node i reads shard
    ``i % P``."""
    from gossipy_tpu_torch.simulation import CohortConfig, NominalTopology
    cohort_size = min(cohort_size, nominal_n)
    shards = min(nominal_n, 4 * cohort_size)
    rng = np.random.default_rng(42)
    w = rng.normal(size=scale.FEATURES)
    X = rng.normal(size=(4 * shards, scale.FEATURES)).astype(np.float32)
    y = (X @ w > 0).astype(np.int64)
    eval_cap = min(scale.EVAL_CAP, max(1, int(0.2 * len(X))))
    disp = DataDispatcher(
        ClassificationDataHandler(X, y, test_size=eval_cap / len(X)),
        n=shards, eval_on_user=False)
    return scale.GossipSimulator(
        scale.scale_handler(), NominalTopology(nominal_n), disp.stacked(),
        delta=scale.ROUND_LEN, protocol=AntiEntropyProtocol.PUSH,
        sampling_eval=0.01, eval_every=rounds, history_dtype=history_dtype,
        cohort=CohortConfig(size=cohort_size, prefetch=prefetch),
        draws=TorchDraws(42), device=device, sentinels=True, perf=True)


def _stamp(msg: str) -> None:
    # Phase-stamped progress: a dead run's last words name where it died.
    print(f"[ladder] {time.strftime('%H:%M:%S')} {msg}", file=sys.stderr,
          flush=True)


def _inject_fault(sim, n_nodes: int) -> None:
    """--fail-at: make this rung's run raise during the run, after its
    simulator was built and its budget banked: the perf layer's post-run
    timing call raises, so the recorder sees an exception out of
    ``sim.start`` as it would an allocator failure."""
    def boom(*a, **k):
        raise RuntimeError(
            f"CUDA out of memory (injected ladder fault at rung {n_nodes}, "
            "--fail-at)")
    sim._attach_perf_stats = boom


def _peak_bytes(sim):
    """The peak allocation the run banked (its last ``CostReport``)."""
    if not sim._cost_reports:
        return None
    return (sim._cost_reports[-1].extra or {}).get("max_memory_allocated")


def run_rung(n_nodes: int, degree: int, rounds: int, out_dir: str,
             history_dtype: str, fail: bool, prev, device,
             cohort_size=None, prefetch: int = 0) -> dict:
    """Run one rung; returns its ladder row. Raises on a rung failure
    with ``ladder_row`` / ``ladder_bundle`` / ``ladder_sim`` attached."""
    from gossipy_tpu_torch.telemetry import FlightRecorder

    row: dict = {"n_nodes": n_nodes, "degree": degree, "rounds": rounds,
                 "history_dtype": history_dtype}
    _stamp(f"rung {n_nodes}: building topology+simulator")
    t0 = time.perf_counter()
    if cohort_size:
        row["nominal_n"] = n_nodes
        row["cohort_size"] = min(cohort_size, n_nodes)
        if prefetch:
            row["prefetch"] = prefetch
        sim = build_cohort_rung_sim(n_nodes, cohort_size, rounds,
                                    history_dtype, prefetch, device)
    else:
        sim = build_rung_sim(n_nodes, degree, rounds, history_dtype, device)
    row["build_seconds"] = time.perf_counter() - t0

    budget = sim.memory_budget()
    analytic = sim._analytic_cost() or {}
    row["predicted"] = {
        "total_bytes": budget.get("total_bytes"),
        "history_ring_bytes": budget.get("history_ring_bytes"),
        "eval_peak_bytes": budget.get("eval_peak_bytes"),
        "pool_resident_bytes": budget.get("cohort_pool_resident"),
        "materialized_prediction_bytes":
            budget.get("cohort_materialized_prediction"),
        "flops_per_round": analytic.get("flops_per_round"),
        "flops_per_round_executed": analytic.get("flops_per_round_executed"),
        # Linear in N from the previous measured rung (flat in nominal N
        # on a cohort rung: its round is [C]-wide at fixed C).
        "ms_per_round": (
            None if prev is None or not prev.get("measured")
            else prev["measured"]["ms_per_round"]
            * (1.0 if cohort_size else n_nodes / prev["n_nodes"])),
    }
    _stamp(f"rung {n_nodes}: predicted "
           f"{(budget.get('total_bytes') or 0) / 2**20:.1f} MB, analytic "
           f"{(row['predicted']['flops_per_round'] or 0) / 1e6:.1f} "
           "MFLOP/round")
    try:
        sim.check_memory_budget()
    except Exception as e:
        e.ladder_row, e.ladder_sim = row, sim
        raise

    suffix = f"_p{prefetch}" if prefetch else ""
    rung_dir = os.path.join(out_dir, f"rung_{n_nodes}{suffix}")
    os.makedirs(rung_dir, exist_ok=True)
    rec = FlightRecorder(rung_dir, chunk=rounds)
    if cohort_size:
        _stamp(f"rung {n_nodes}: init_cohort_pool (C {row['cohort_size']})")
        state = sim.init_cohort_pool(set_seed(42))
    else:
        _stamp(f"rung {n_nodes}: init_nodes")
        state = sim.init_nodes(set_seed(42))
    # One untimed start of the same length first, so that the timed run
    # is warm: the first round's lazy tables and the kernels' first
    # launches fall in the warm-up, not in the rung's ms/round.
    _stamp(f"rung {n_nodes}: {rounds}-round warm-up start")
    state, _ = sim.start(state, n_rounds=rounds)
    row["warmup_rounds"] = rounds
    if fail:
        _inject_fault(sim, n_nodes)
    _stamp(f"rung {n_nodes}: {rounds}-round run (flight recorder armed)")
    try:
        state, _, bundle = rec.run(sim, state, n_rounds=rounds)
    except Exception as e:
        e.ladder_row, e.ladder_sim = row, sim
        e.ladder_bundle = rec.bundle_path
        raise
    if bundle is not None:
        e = RuntimeError(f"rung {n_nodes}: sentinel tripped (bundle at "
                         f"{bundle})")
        e.ladder_row, e.ladder_sim, e.ladder_bundle = row, sim, bundle
        raise e

    last = sim._perf_last or {}
    ms = last.get("ms_per_round")
    peak = _peak_bytes(sim)
    row["measured"] = {
        "ms_per_round": ms,
        "rounds_per_sec": (1e3 / ms if ms else None),
        "mfu_est": last.get("mfu_est"),
        "flops_per_round_xla": None,
        "bytes_per_round_xla": None,
        "hbm_peak_bytes": peak,
        "temp_bytes": None,
        "compile_seconds": None,
        "program": (sim._cost_reports[-1].label if sim._cost_reports
                    else None),
        "cold": last.get("cold"),
    }
    pred_ms = row["predicted"]["ms_per_round"]
    if pred_ms and ms:
        row["time_predicted_over_measured"] = pred_ms / ms
    pred_b = row["predicted"]["total_bytes"]
    if pred_b and peak:
        row["memory_predicted_over_measured"] = pred_b / peak
    _stamp(f"rung {n_nodes}: {ms and round(ms, 3)} ms/round, peak "
           f"{(peak or 0) / 2**20:.1f} MB")
    return row


def verdict_for(exc: Exception, n_nodes: int, last_healthy) -> dict:
    """The ladder verdict: the failing rung, its banked budget and peak
    (the run's ``CostReport``, banked before the failure; the
    construction-time budget when the rung died before its run), and the
    last healthy rung."""
    sim = getattr(exc, "ladder_sim", None)
    row = getattr(exc, "ladder_row", None) or {}
    program = None
    memory = None
    if sim is not None and getattr(sim, "_cost_reports", None):
        program = sim._cost_reports[-1].label
        memory = {"peak_bytes": _peak_bytes(sim)}
    if memory is None:
        program = "not run (failed before the rounds)"
        memory = {"memory_budget_fallback": row.get("predicted")}
    verdict = {
        "failed_rung": n_nodes,
        "last_healthy_rung": last_healthy,
        "program": program,
        "memory_analysis": memory,
        "budget_bytes": (row.get("predicted") or {}).get("total_bytes"),
        "peak_bytes": memory.get("peak_bytes"),
        "predicted": row.get("predicted"),
        "error": repr(exc)[:500],
        "bundle": getattr(exc, "ladder_bundle", None),
    }
    if type(exc).__name__ == "MemoryBudgetExceeded":
        verdict["degrade_reason"] = "memory_budget_refused"
        verdict["dominant_term"] = getattr(exc, "dominant_term", None)
        verdict["predicted_bytes"] = getattr(exc, "predicted_bytes", None)
        verdict["limit_bytes"] = getattr(exc, "limit_bytes", None)
        verdict["program"] = "refused before launch (memory budget)"
    return verdict


def markdown(rows: list, verdict) -> str:
    lines = [
        "| N | nominal_n | predicted MB | pool MB | peak MB | ms/round | "
        "rounds/s | MFU est | stream× | pred/meas time | pred/meas memory |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]

    def mb(v):
        return f"{v / 2**20:.1f}" if v else "—"
    for r in rows:
        m = r.get("measured") or {}
        p = r.get("predicted") or {}
        mfu = m.get("mfu_est")
        width = r.get("cohort_size") or r["n_nodes"]
        wcell = (f"{width:,} (pf {r['prefetch']})" if r.get("prefetch")
                 else f"{width:,}")
        spd = r.get("stream_speedup")
        tpm = r.get("time_predicted_over_measured")
        mpm = r.get("memory_predicted_over_measured")
        lines.append(
            f"| {wcell} | {r.get('nominal_n', r['n_nodes']):,} "
            f"| {mb(p.get('total_bytes'))} "
            f"| {mb(p.get('pool_resident_bytes'))} "
            f"| {mb(m.get('hbm_peak_bytes'))} "
            f"| {m.get('ms_per_round') and round(m['ms_per_round'], 3)} "
            f"| {m.get('rounds_per_sec') and round(m['rounds_per_sec'], 3)} "
            f"| {f'{mfu:.3e}' if mfu is not None else 'null'} "
            f"| {f'{spd:.2f}x' if spd else ''} "
            f"| {f'{tpm:.3f}' if tpm else '—'} "
            f"| {f'{mpm:.3f}' if mpm else '—'} |")
    if verdict is not None:
        refused = verdict.get("degrade_reason") == "memory_budget_refused"
        lines += ["", (
            f"**{'REFUSED' if refused else 'FAILED'}** at rung "
            f"{verdict['failed_rung']:,} (last healthy: "
            f"{verdict['last_healthy_rung']}): program "
            f"`{verdict['program']}`, budget {mb(verdict['budget_bytes'])} "
            f"MB, peak {mb(verdict['peak_bytes'])} MB, "
            + (f"dominant budget term `{verdict.get('dominant_term')}`, "
               if refused else "")
            + f"`{verdict['error']}`")]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rungs", default=None,
                    help="comma-separated node counts "
                         "(default: 1k,2k,5k,10k,20k,50k,100k)")
    ap.add_argument("--smoke", action="store_true",
                    help=f"tiny rungs {SMOKE_RUNGS}")
    ap.add_argument("--rounds", type=int, default=None,
                    help="rounds per rung (default 100; 3 with --smoke)")
    ap.add_argument("--degree", type=int, default=None,
                    help="regular-graph degree (default 20; 4 with "
                         "--smoke)")
    ap.add_argument("--cohort", action="store_true",
                    help=f"active-cohort rungs: nominal N in {COHORT_RUNGS}"
                         " at a fixed materialized C (--cohort-size)")
    ap.add_argument("--cohort-size", type=int, default=None,
                    help="materialized cohort width C for --cohort "
                         "(default 1024; 64 with --smoke)")
    ap.add_argument("--stream", action="store_true",
                    help="with --cohort: a serial + streaming (prefetch) "
                         "pair a rung")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="prefetch depth for --stream rows (default 2)")
    ap.add_argument("--out", default="ladder-artifacts")
    ap.add_argument("--history-dtype", default="float32",
                    choices=("float32", "bfloat16", "int8"))
    ap.add_argument("--fail-at", type=int, default=None, metavar="N",
                    help="inject a fault into rung N during its run (the "
                         "verdict must name it)")
    ap.add_argument("--ledger", default=None, metavar="PATH",
                    help="run-ledger file to append one digest row a rung "
                         "to (default: $GOSSIPY_TPU_LEDGER)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.rungs:
        try:
            rungs = tuple(int(x) for x in args.rungs.split(","))
        except ValueError:
            print(f"[ladder] unparsable --rungs {args.rungs!r}",
                  file=sys.stderr)
            return 2
        if any(r < 2 for r in rungs):
            print("[ladder] rungs must be >= 2", file=sys.stderr)
            return 2
    elif args.cohort:
        rungs = SMOKE_COHORT_RUNGS if args.smoke else COHORT_RUNGS
    else:
        rungs = SMOKE_RUNGS if args.smoke else DEFAULT_RUNGS
    if args.stream and not args.cohort:
        print("[ladder] --stream requires --cohort", file=sys.stderr)
        return 2
    cohort_size = None
    if args.cohort:
        cohort_size = args.cohort_size or (64 if args.smoke else 1024)
    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    _stamp(f"device {dev} ({kind}); rungs {rungs}")

    rows: list = []
    verdict = None
    last_healthy = None
    for n in rungs:
        cfg = rung_config(n, args.smoke, args.rounds, args.degree)
        srow = None
        try:
            row = run_rung(n, cfg["degree"], cfg["rounds"], args.out,
                           args.history_dtype, fail=(args.fail_at == n),
                           prev=rows[-1] if rows else None, device=dev,
                           cohort_size=cohort_size)
            if args.stream:
                srow = run_rung(n, cfg["degree"], cfg["rounds"], args.out,
                                args.history_dtype, fail=False, prev=None,
                                device=dev, cohort_size=cohort_size,
                                prefetch=args.prefetch)
                ser = (row.get("measured") or {}).get("ms_per_round")
                st = (srow.get("measured") or {}).get("ms_per_round")
                if ser and st:
                    srow["stream_speedup"] = ser / st
                    _stamp(f"rung {n}: stream pair "
                           f"{srow['stream_speedup']:.3f}x (serial "
                           f"{ser:.2f} -> prefetch {st:.2f} ms/round)")
        except Exception as e:
            verdict = verdict_for(e, n, last_healthy)
            rows.append(getattr(e, "ladder_row", None)
                        or {"n_nodes": n, "failed": True})
            _stamp(f"rung {n} FAILED: {verdict['error']} (bundle "
                   f"{verdict['bundle']})")
            break
        rows.append(row)
        if srow is not None:
            rows.append(srow)
        last_healthy = n
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    out = {"schema": 2, "backend": dev.type, "cohort_size": cohort_size,
           "device_kind": kind,
           "rounds_per_rung": rung_config(rungs[0], args.smoke, args.rounds,
                                          args.degree)["rounds"],
           "rungs": rows, "verdict": verdict}
    path = os.path.join(args.out, "ladder.json")
    with open(path, "w") as fh:
        json.dump(out, fh, indent=2)
        fh.write("\n")
    md_path = os.path.join(args.out, "ladder.md")
    with open(md_path, "w") as fh:
        fh.write(markdown([r for r in rows if "predicted" in r], verdict))
    _stamp(f"wrote {path} and {md_path} ({len(rows)} rungs"
           f"{'; VERDICT' if verdict else ''})")
    from gossipy_tpu_torch.telemetry.ledger import ingest_ladder, \
        resolve_ledger
    led = resolve_ledger(args.ledger or None)
    if led is not None:
        n_rows = len(ingest_ladder(led, out, path=path))
        _stamp(f"ledger: {n_rows} row(s) -> {led.path}")
    return 1 if verdict else 0


if __name__ == "__main__":
    sys.exit(main())
