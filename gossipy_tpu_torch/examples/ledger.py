"""Run-ledger forensics CLI: list / show / diff / trend / bisect / merge.

Twin of the JAX package's ``scripts/ledger.py`` over the port's
:class:`gossipy_tpu_torch.telemetry.RunLedger` (the same file format: a
ledger either package appends to reads in both):

``list PATH``
    Markdown table of every row (filter ``--kind/--backend/--config
    k=v``; ``--metric NAME`` adds that metric's column and drops rows
    without it; ``--json`` for machines).
``show PATH RUN_ID``
    The full row (abbreviated run ids accepted, git style; ``@i``
    indexes rows in file order, ``@-1`` is the newest).
``diff PATH A B``
    What changed between two runs: config-field diff (dotted keys),
    headline metric deltas, code versions — and, when both rows link a
    live report.json artifact, the FIRST DIVERGENT ROUND of the two
    runs' per-round accounting (sent/failed/eval curves).
    ``--expect-config-diff`` exits 1 unless at least one config field
    differs.
``trend PATH --metric M``
    The bench-trend regression gate over any ledger metric (its own copy
    of ``scripts/bench_trend.py::analyze``): per-backend groups, latest
    non-degraded row vs best prior, ``--max-regress`` budget.
``bisect PATH ROW --baseline BASE``
    A ``git bisect run`` helper: replays ROW's pinned experiment config
    (the port's ``config.run_experiment``, on ``--device``) at the
    CURRENT checkout, measures the headline metric and exits git-bisect
    style — 0 (good) when within ``--tol`` of BASE's recorded value, 1
    (bad) when worse, 125 (skip) when the row carries no replayable
    config or the replay itself fails::

        git bisect start BAD GOOD
        git bisect run python3 -m gossipy_tpu_torch.examples.ledger \\
            bisect ledger.jsonl <row> --baseline <base> \\
            --metric final_accuracy

``merge OUT IN [IN...]``
    Fold several per-process ledgers into one index (associative,
    commutative, idempotent — ``merge_ledgers``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# Metrics where smaller is better (bisect/trend direction; everything
# else — rounds/sec, MFU, speedups, accuracy — regresses DOWN).
_LOWER_BETTER = ("_ms", "_seconds", "host_blocked_frac")


def _lower_is_better(metric: str) -> bool:
    return metric.endswith(_LOWER_BETTER)


def _load(path: str):
    from gossipy_tpu_torch.telemetry.ledger import RunLedger
    led = RunLedger(path)
    doc = led.read()
    if doc["skipped"]:
        print(f"[ledger] {path}: skipped {doc['skipped']} torn/corrupt "
              "line(s)", file=sys.stderr)
    return doc["rows"]


def _resolve(rows: list, ref: str) -> dict:
    """One row from a ``@i`` index or a run-id prefix; ambiguity and
    misses are hard errors (forensics must never guess)."""
    if ref.startswith("@"):
        try:
            return rows[int(ref[1:])]
        except (ValueError, IndexError):
            raise SystemExit(f"ledger: no row at index {ref!r} "
                             f"({len(rows)} rows)")
    hits = [r for r in rows
            if str(r.get("run_id", "")).startswith(ref)]
    if not hits:
        raise SystemExit(f"ledger: no row with run id {ref!r}")
    if len(hits) > 1:
        ids = ", ".join(str(r.get("run_id")) for r in hits[:8])
        raise SystemExit(f"ledger: run id {ref!r} is ambiguous ({ids})")
    return hits[0]


def _flatten(d: dict, prefix: str = "") -> dict:
    out: dict = {}
    for k in sorted(d, key=str):
        v = d[k]
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def _fmt_ts(ts) -> str:
    try:
        return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(ts))
    except (TypeError, ValueError, OverflowError):
        return "?"


def _match_filters(row: dict, args) -> bool:
    if args.kind and row.get("kind") != args.kind:
        return False
    if args.backend and row.get("backend") != args.backend:
        return False
    if getattr(args, "metric", None) and \
            args.metric not in (row.get("metrics") or {}):
        return False
    for spec in getattr(args, "config", None) or []:
        field, _, want = spec.partition("=")
        flat = _flatten(row.get("config") or {})
        if str(flat.get(field)) != want:
            return False
    return True


# -- list / show -------------------------------------------------------------

def cmd_list(args) -> int:
    rows = [r for r in _load(args.path) if _match_filters(r, args)]
    if args.json:
        out = json.dumps(rows, indent=2)
    else:
        metric_cols = [args.metric] if args.metric else \
            ["rounds_per_sec", "final_accuracy", "slo_p99_ms"]
        head = (["run id", "when", "kind", "backend", "config"]
                + metric_cols + ["failure"])
        lines = ["# Run ledger — " + os.path.basename(args.path), "",
                 "| " + " | ".join(head) + " |",
                 "|" + "---|" * len(head)]
        for r in rows:
            metrics = r.get("metrics") or {}
            cells = [str(r.get("run_id", "?")), _fmt_ts(r.get("ts")),
                     str(r.get("kind", "?")),
                     str(r.get("backend") or ""),
                     str(r.get("config_fingerprint") or "")[:8]]
            for m in metric_cols:
                v = metrics.get(m)
                cells.append(f"{v:.4g}" if isinstance(v, float) else
                             ("" if v is None else str(v)))
            fail = r.get("failure") or {}
            cells.append(str(fail.get("kind", "")) if fail else "")
            lines.append("| " + " | ".join(cells) + " |")
        lines.append("")
        lines.append(f"{len(rows)} row(s)")
        out = "\n".join(lines) + "\n"
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(out)
        print(f"[ledger] {len(rows)} row(s) -> {args.out}",
              file=sys.stderr)
    else:
        print(out)
    return 0


def cmd_show(args) -> int:
    row = _resolve(_load(args.path), args.run_id)
    print(json.dumps(row, indent=2, sort_keys=True))
    return 0


# -- diff --------------------------------------------------------------------

def _first_divergent_round(row_a: dict, row_b: dict):
    """1-based first round where the two runs' per-round accounting
    (sent/failed, then the eval curves) differs, via the rows' linked
    report.json artifacts — None when either report is not live or the
    runs never diverge over their common prefix."""
    import numpy as np

    from gossipy_tpu_torch.simulation.report import SimulationReport
    reports = []
    for row in (row_a, row_b):
        path = ((row.get("artifacts") or {}).get("report") or {}) \
            .get("path")
        if not path or not os.path.exists(path):
            return None
        try:
            reports.append(SimulationReport.load(path))
        except Exception:
            return None
    ra, rb = reports
    series = [(ra.sent_per_round, rb.sent_per_round),
              (ra.failed_per_round, rb.failed_per_round)]
    ca = ra.curves(local=False, drop_nan=False)
    cb = rb.curves(local=False, drop_nan=False)
    for name in ca:
        if name in cb:
            series.append((ca[name], cb[name]))
    first = None
    for a, b in series:
        a, b = np.asarray(a, float), np.asarray(b, float)
        n = min(len(a), len(b))
        if n == 0:
            continue
        a, b = a[:n], b[:n]
        neq = ~((a == b) | (np.isnan(a) & np.isnan(b)))
        idx = np.nonzero(neq)[0]
        if len(idx):
            r = int(idx[0]) + 1
            first = r if first is None else min(first, r)
    return first


def diff_rows(row_a: dict, row_b: dict) -> dict:
    """The forensic diff between two ledger rows (pure function — the
    e2e test and the CLI share it)."""
    flat_a = _flatten(row_a.get("config") or {})
    flat_b = _flatten(row_b.get("config") or {})
    config_diff = {
        k: {"a": flat_a.get(k), "b": flat_b.get(k)}
        for k in sorted(set(flat_a) | set(flat_b))
        if flat_a.get(k) != flat_b.get(k)
    }
    ma, mb = row_a.get("metrics") or {}, row_b.get("metrics") or {}
    metric_deltas = {}
    for k in sorted(set(ma) | set(mb)):
        a, b = ma.get(k), mb.get(k)
        entry: dict = {"a": a, "b": b}
        if isinstance(a, (int, float)) and isinstance(b, (int, float)):
            entry["delta"] = b - a
            if a:
                entry["pct"] = (b - a) / abs(a)
        metric_deltas[k] = entry
    cv = {side: ((row.get("code_version") or {}).get("git_sha"))
          for side, row in (("a", row_a), ("b", row_b))}
    return {
        "a": row_a.get("run_id"), "b": row_b.get("run_id"),
        "kinds": [row_a.get("kind"), row_b.get("kind")],
        "fingerprint_changed": (row_a.get("config_fingerprint")
                                != row_b.get("config_fingerprint")),
        "config_diff": config_diff,
        "metric_deltas": metric_deltas,
        "code_version": cv,
        "first_divergent_round": _first_divergent_round(row_a, row_b),
    }


def cmd_diff(args) -> int:
    rows = _load(args.path)
    d = diff_rows(_resolve(rows, args.a), _resolve(rows, args.b))
    if args.json:
        print(json.dumps(d, indent=2))
    else:
        print(f"ledger diff {d['a']} ({d['kinds'][0]}) -> "
              f"{d['b']} ({d['kinds'][1]})")
        print(f"  code: {d['code_version']['a']} -> "
              f"{d['code_version']['b']}  fingerprint "
              f"{'CHANGED' if d['fingerprint_changed'] else 'same'}")
        if d["config_diff"]:
            print("  config:")
            for k, v in d["config_diff"].items():
                print(f"    {k}: {v['a']!r} -> {v['b']!r}")
        else:
            print("  config: identical")
        for k, v in d["metric_deltas"].items():
            pct = f" ({v['pct']:+.1%})" if "pct" in v else ""
            print(f"  {k}: {v['a']} -> {v['b']}{pct}")
        if d["first_divergent_round"] is not None:
            print(f"  first divergent round: "
                  f"{d['first_divergent_round']} (from linked reports)")
    if args.expect_config_diff and not d["config_diff"]:
        print("[ledger] diff: expected config fields to differ, none do",
              file=sys.stderr)
        return 1
    return 0


# -- the bench-trend gate: scripts/bench_trend.py's analyze and its helpers,
# copied (that script belongs to the JAX package) ---------------------------

_LOWER_BETTER_UNITS = {"s", "ms", "seconds", "milliseconds"}


def lower_is_better(row: dict) -> bool:
    unit = str(row.get("unit", "")).lower()
    metric = str(row.get("metric", ""))
    return unit in _LOWER_BETTER_UNITS or \
        metric.endswith(("_seconds", "_ms"))


def _group_key(row: dict) -> tuple:
    raw = row.get("raw") or {}
    return (row["metric"], str(raw.get("backend", "unrecorded")))


def _degraded(row: dict) -> bool:
    return bool((row.get("raw") or {}).get("degraded"))


def analyze(entries: list, max_regress: float) -> tuple[str, list]:
    """(markdown trend table, regression list). Regressions compare the
    latest non-degraded row per (metric, backend) group against the best
    prior non-degraded row in the same group."""
    groups: dict[tuple, list] = {}
    for e in entries:
        groups.setdefault(_group_key(e["row"]), []).append(e)

    lines = ["# Bench trend", ""]
    regressions = []
    for (metric, backend) in sorted(groups):
        es = sorted(groups[(metric, backend)], key=lambda e: e["order"])
        lines += [f"## {metric} ({backend})", "",
                  "| source | value | unit | host blk% | stream× "
                  "| deliver× | deliver MB | degraded | note |",
                  "|---|---:|---|---:|---:|---:|---:|---|---|"]
        clean = [e for e in es if not _degraded(e["row"])]
        best_prior = None
        if len(clean) >= 2:
            prior = clean[:-1]
            vals = [e["row"]["value"] for e in prior]
            best_prior = (min(vals) if lower_is_better(clean[-1]["row"])
                          else max(vals))
        for e in es:
            row = e["row"]
            note = ""
            if clean and e is clean[-1] and best_prior is not None:
                lib = lower_is_better(row)
                delta = (best_prior - row["value"]) / best_prior \
                    if lib else (row["value"] - best_prior) / best_prior
                note = f"{delta:+.1%} vs best prior ({best_prior})"
                if delta < -max_regress:
                    regressions.append(
                        f"{metric} ({backend}): {e['source']} = "
                        f"{row['value']} {row.get('unit', '')} is "
                        f"{-delta:.1%} worse than best prior "
                        f"{best_prior} (> {max_regress:.0%} budget)")
                    note += "  **REGRESSION**"
            reason = (row.get("raw") or {}).get("degrade_reason", "")
            # host_blocked_frac: stamped by scripts/trace_report.py /
            # bench.py when the run was traced (telemetry.tracing) —
            # how much of the wall the host spent off the device's
            # critical path. Blank for untraced rows.
            hbf = (row.get("raw") or {}).get("host_blocked_frac")
            hbf_cell = f"{float(hbf) * 100:.1f}" if hbf is not None else ""
            # stream_speedup: bench.py --cohort's prefetch-pipeline A/B
            # (streaming wall vs serial wall, same config). Blank for
            # rows without a streaming variant.
            spd = (row.get("raw") or {}).get("stream_speedup")
            spd_cell = f"{float(spd):.2f}" if spd is not None else ""
            # deliver_ms_per_round / deliver_bytes_moved: bench.py
            # --fused-regime's per-leg deliver-phase A/B. deliver× is
            # the multi-slot kernel's gain over the per-slot fused leg
            # (same config, same trace harness); deliver MB is the
            # multi leg's modelled bytes moved per deliver phase. Blank
            # for rows without the fused A/B.
            dms = (row.get("raw") or {}).get("deliver_ms_per_round") or {}
            dlv_cell = ""
            if dms.get("per_slot") and dms.get("multi"):
                dlv_cell = f"{float(dms['per_slot']) / float(dms['multi']):.2f}"
            dbm = (row.get("raw") or {}).get("deliver_bytes_moved") or {}
            dmb_cell = f"{float(dbm['multi']) / 1e6:.1f}" \
                if dbm.get("multi") is not None else ""
            lines.append(
                f"| {e['source']} | {row['value']} "
                f"| {row.get('unit', '')} "
                f"| {hbf_cell} "
                f"| {spd_cell} "
                f"| {dlv_cell} "
                f"| {dmb_cell} "
                f"| {'yes — ' + reason if _degraded(row) else ''} "
                f"| {note} |")
        lines.append("")
    if not groups:
        lines.append("(no bench rows found)")
    return "\n".join(lines) + "\n", regressions


# -- trend -------------------------------------------------------------------

def cmd_trend(args) -> int:
    """The bench-trend gate over any ledger metric: ledger rows become
    pseudo bench rows and flow through :func:`analyze`."""
    entries = []
    rows = [r for r in _load(args.path) if _match_filters(r, args)]
    rows.sort(key=lambda r: r.get("ts") or 0.0)
    unit = "ms" if args.metric.endswith("_ms") else ""
    for order, r in enumerate(rows):
        v = (r.get("metrics") or {}).get(args.metric)
        if v is None:
            continue
        entries.append({
            "source": f"{r.get('run_id', '?')}[{r.get('kind', '?')}]",
            "order": order,
            "row": {"metric": args.metric, "value": v, "unit": unit,
                    "raw": {"backend": r.get("backend", "unrecorded"),
                            "degraded": bool(r.get("degraded"))}}})
    table, regressions = analyze(entries, args.max_regress)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(table)
        print(f"[ledger] trend: {len(entries)} row(s) -> {args.out}",
              file=sys.stderr)
    else:
        print(table)
    for r in regressions:
        print(f"[ledger] REGRESSION: {r}", file=sys.stderr)
    return 1 if regressions else 0


# -- bisect ------------------------------------------------------------------

def _replay_metric(row: dict, metric: str, device=None):
    """Re-run the row's pinned experiment config at the current checkout
    (on ``device``: the card unless ``"cpu"``) and measure ``metric``.
    Returns a float, or raises (callers map failures to exit 125 — git
    bisect's skip)."""
    import time as _time

    from gossipy_tpu_torch.config import ExperimentConfig, run_experiment
    cfg = ExperimentConfig.from_dict(dict(row["experiment"]))
    t0 = _time.perf_counter()
    _state, report = run_experiment(cfg, device=device)
    wall = _time.perf_counter() - t0
    if isinstance(report, list):  # cfg.repetitions > 1
        report = report[0]
    if metric == "final_accuracy":
        for name in ("accuracy", "auc", "f1"):
            v = report.final(name)
            if v == v:
                return float(v)
        raise RuntimeError("replay produced no finite eval metric")
    if metric == "rounds_per_sec":
        # Includes the build and any kernel build — coarse, but
        # consistent across the bisected commits; keep --tol generous.
        return float(cfg.n_rounds) / max(wall, 1e-9)
    raise RuntimeError(f"bisect cannot measure metric {metric!r}")


def cmd_bisect(args) -> int:
    SKIP = 125
    try:
        rows = _load(args.path)
        row = _resolve(rows, args.row)
        base = _resolve(rows, args.baseline)
    except SystemExit as e:
        print(f"[bisect] skip: {e}", file=sys.stderr)
        return SKIP
    baseline = (base.get("metrics") or {}).get(args.metric)
    if not isinstance(baseline, (int, float)):
        print(f"[bisect] skip: baseline row {base.get('run_id')} has no "
              f"recorded {args.metric}", file=sys.stderr)
        return SKIP
    if not isinstance(row.get("experiment"), dict):
        print(f"[bisect] skip: row {row.get('run_id')} carries no "
              "replayable experiment config", file=sys.stderr)
        return SKIP
    try:
        measured = _replay_metric(row, args.metric, args.device)
    except Exception as e:
        print(f"[bisect] skip: replay failed: {e!r}", file=sys.stderr)
        return SKIP
    lib = _lower_is_better(args.metric)
    if lib:
        bad = measured > baseline * (1.0 + args.tol)
    else:
        bad = measured < baseline * (1.0 - args.tol)
    verdict = "BAD" if bad else "good"
    print(f"[bisect] {args.metric}: measured {measured:.6g} vs baseline "
          f"{baseline:.6g} (tol {args.tol:.0%}, "
          f"{'lower' if lib else 'higher'}-is-better) -> {verdict}",
          file=sys.stderr)
    print(json.dumps({"metric": args.metric, "measured": measured,
                      "baseline": baseline, "tol": args.tol,
                      "verdict": verdict}))
    return 1 if bad else 0


# -- merge -------------------------------------------------------------------

def cmd_merge(args) -> int:
    from gossipy_tpu_torch.telemetry.ledger import merge_ledger_files
    n = merge_ledger_files(args.out, args.inputs)
    print(f"[ledger] merged {len(args.inputs)} file(s) -> {args.out} "
          f"({n} rows)", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("list", help="markdown table of rows")
    p.add_argument("path")
    p.add_argument("--kind", default=None)
    p.add_argument("--backend", default=None)
    p.add_argument("--metric", default=None,
                   help="only rows carrying this metric; adds its column")
    p.add_argument("--config", action="append", default=[],
                   metavar="FIELD=VALUE",
                   help="filter on a (dotted) config field (repeatable)")
    p.add_argument("--json", action="store_true")
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("show", help="one full row")
    p.add_argument("path")
    p.add_argument("run_id", help="run-id prefix or @index")
    p.set_defaults(fn=cmd_show)

    p = sub.add_parser("diff", help="config + metric diff of two rows")
    p.add_argument("path")
    p.add_argument("a", help="run-id prefix or @index")
    p.add_argument("b", help="run-id prefix or @index")
    p.add_argument("--json", action="store_true")
    p.add_argument("--expect-config-diff", action="store_true",
                   help="exit 1 unless at least one config field differs")
    p.set_defaults(fn=cmd_diff)

    p = sub.add_parser("trend",
                       help="the bench-trend gate over any ledger metric")
    p.add_argument("path")
    p.add_argument("--metric", required=True)
    p.add_argument("--kind", default=None)
    p.add_argument("--backend", default=None)
    p.add_argument("--config", action="append", default=[],
                   metavar="FIELD=VALUE")
    p.add_argument("--max-regress", type=float, default=0.15)
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_trend)

    p = sub.add_parser("bisect", help="git bisect run helper")
    p.add_argument("path")
    p.add_argument("row", help="row to replay (run-id prefix or @index)")
    p.add_argument("--baseline", required=True,
                   help="row whose recorded metric is the good value")
    p.add_argument("--metric", default="final_accuracy",
                   choices=("final_accuracy", "rounds_per_sec"))
    p.add_argument("--tol", type=float, default=0.15,
                   help="tolerated fractional regression (default 0.15)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu, for the replay")
    p.set_defaults(fn=cmd_bisect)

    p = sub.add_parser("merge", help="fold ledgers into one index")
    p.add_argument("out")
    p.add_argument("inputs", nargs="+")
    p.set_defaults(fn=cmd_merge)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
