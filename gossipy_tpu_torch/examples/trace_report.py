"""trace_report: critical-path analysis of a host span trace.

Twin of the JAX package's ``scripts/trace_report.py``. Reads one or more
``trace.json`` files written by the host span tracer
(:mod:`gossipy_tpu_torch.telemetry.tracing`: runs with ``tracing=``, the
checkpoint and flight-recorder spans), reduces them with
:func:`~gossipy_tpu_torch.telemetry.tracing.trace_report`, and writes
``trace_report.json`` next to the (first) input:

- **totals** — wall_ms, host_busy_ms, host_blocked_ms, device_ms,
  overlap_ms, unaccounted_ms, plus host_blocked_frac / overlap_frac /
  unaccounted_frac over every recorded run window;
- **per_round** — the same attribution divided by each window's round
  count: per-round host_blocked_ms / device_ms / overlap_frac;
- **critical_path** — span names ranked by their exclusive
  contribution to the non-overlapped timeline (what to optimize next).

Multiple inputs are merged first (``merge_traces`` — associative, so
per-process traces reduce in any order) and analyzed as ONE timeline;
windows from different pids never overlap-count each other.

``--bench-row`` stamps ``raw.host_blocked_frac`` (and
``raw.trace_overlap_frac``) into an existing bench-row JSON file in
place, so a trend table can fold host efficiency in next to the
throughput number it explains.

Usage::

    python3 -m gossipy_tpu_torch.examples.trace_report runs/trace.json
    python3 -m gossipy_tpu_torch.examples.trace_report p0/trace.json \\
        p1/trace.json --out merged_report.json
    python3 -m gossipy_tpu_torch.examples.trace_report runs/trace.json \\
        --bench-row runs/row.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from gossipy_tpu_torch.telemetry.tracing import merge_traces, trace_report


def load_traces(paths: list) -> dict:
    merged = None
    for path in paths:
        with open(path) as fh:
            snap = json.load(fh)
        if "traceEvents" not in snap:
            raise SystemExit(f"{path}: not a Chrome trace object "
                             "(no 'traceEvents' key)")
        merged = snap if merged is None else merge_traces(merged, snap)
    return merged


def summarize(report: dict) -> str:
    t = report["totals"]

    def frac(key):
        v = t.get(key)
        return f"{v:.1%}" if v is not None else "n/a"

    lines = [
        f"windows analyzed      {report['n_windows']}"
        f"  ({t['rounds']} rounds)",
        f"wall                  {t['wall_ms']:>10.1f} ms",
        f"device                {t['device_ms']:>10.1f} ms",
        f"host busy             {t['host_busy_ms']:>10.1f} ms"
        f"  (overlap with device: {frac('overlap_frac')})",
        f"host blocked          {t['host_blocked_ms']:>10.1f} ms"
        f"  ({frac('host_blocked_frac')} of wall)",
        f"unaccounted           {t['unaccounted_ms']:>10.1f} ms"
        f"  ({frac('unaccounted_frac')} of wall)",
    ]
    pr = report.get("per_round") or []
    if pr:
        n = len(pr)
        hb = sum(r["host_blocked_ms"] for r in pr) / n
        dv = sum(r["device_ms"] for r in pr) / n
        lines.append(f"per round (mean)      host_blocked {hb:.2f} ms "
                     f"| device {dv:.2f} ms")
    cp = report.get("critical_path") or []
    if cp:
        lines.append("critical path (non-overlapped ms):")
        for entry in cp[:10]:
            fr = (f"{entry['frac']:.1%}" if entry.get("frac") is not None
                  else "n/a")
            lines.append(f"  {entry['name']:<28} {entry['ms']:>10.1f}"
                         f"  ({fr})")
    return "\n".join(lines)


def stamp_bench_row(row_path: str, report: dict) -> None:
    """Fold the trace totals into an existing bench row IN PLACE
    (capsule ``{"parsed": row}`` files and bare rows both work)."""
    with open(row_path) as fh:
        doc = json.load(fh)
    row = doc.get("parsed", doc)
    if "metric" not in row:
        raise SystemExit(f"--bench-row {row_path}: not a bench row "
                         "(no 'metric' field)")
    raw = row.setdefault("raw", {})
    t = report["totals"]
    raw["host_blocked_frac"] = t["host_blocked_frac"]
    raw["trace_overlap_frac"] = t["overlap_frac"]
    raw["trace_host_blocked_ms"] = t["host_blocked_ms"]
    tmp = row_path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=2)
        fh.write("\n")
    os.replace(tmp, row_path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("traces", nargs="+",
                    help="trace.json file(s); several are merged "
                         "(merge_traces) before analysis")
    ap.add_argument("--out", default=None,
                    help="report path (default: trace_report.json next "
                         "to the first input)")
    ap.add_argument("--bench-row", default=None,
                    help="bench-row JSON to stamp raw.host_blocked_frac "
                         "into, in place")
    args = ap.parse_args(argv)

    snap = load_traces(args.traces)
    report = trace_report(snap)
    out = args.out or os.path.join(
        os.path.dirname(os.path.abspath(args.traces[0])),
        "trace_report.json")
    tmp = out + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(report, fh, indent=2)
        fh.write("\n")
    os.replace(tmp, out)
    print(summarize(report))
    print(f"[trace_report] report -> {out}", file=sys.stderr)
    if args.bench_row:
        stamp_bench_row(args.bench_row, report)
        print(f"[trace_report] stamped host_blocked_frac into "
              f"{args.bench_row}", file=sys.stderr)
    if report["n_windows"] == 0:
        print("[trace_report] WARNING: no run windows in trace — totals "
              "are empty (was the traced segment ever entered?)",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
