"""Sustained mixed-shape arrival harness: the service SLO benchmark.

Twin of the JAX package's ``scripts/loadgen.py``. Drives
:func:`gossipy_tpu_torch.service.slo.run_load`: Poisson tenant arrivals
over a mixed-shape spec pool, served open loop by an incremental
:class:`~gossipy_tpu_torch.service.scheduler.ServiceSession` (arrivals
interleave with running buckets, so queue wait and time-to-first-round
are measured under real contention), and emits the ``service_slo``
row::

    {"metric": "service_slo", "value": <tenants/hour>,
     "unit": "tenants/hour",
     "raw": {"tenants_per_hour", "ttfr_p50_ms", "ttfr_p99_ms",
             "round_p50_ms", "round_p99_ms", "queue_wait_p99_ms",
             "n_admitted", "ttfr_missing": [], ...}}

Stdout carries the one row JSON line; the readable account goes to
stderr. Artifacts under ``--out``: per-tenant report/manifest/events
(the service layout), ``slo_row.json`` (the row),
``metrics/metrics.json`` + ``metrics/metrics.prom`` (the registry's
snapshot and OpenMetrics export; tail the former live with the
``service_top`` twin), and ``metrics/trace.json`` +
``trace_report.json`` (the host span timeline and its critical-path
account; the row carries ``raw.host_blocked_frac`` from it).

Exit status: 0 only when every admitted tenant finished (DONE or
EVICTED) with a recorded time-to-first-round; 1 otherwise.

Usage::

    python3 -m gossipy_tpu_torch.examples.loadgen --out load-runs --tenants 6 --rate 1200
    python3 -m gossipy_tpu_torch.examples.loadgen --out load-runs --pool pool.json \\
        --tenants 20 --rate 600 --time-scale 0.01
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from gossipy_tpu_torch import resolve_device
from gossipy_tpu_torch.service.slo import default_spec_pool, run_load
from gossipy_tpu_torch.telemetry.ledger import ingest_slo_row, resolve_ledger
from gossipy_tpu_torch.telemetry.tracing import Tracer, trace_report


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="load-runs",
                    help="artifact root (service layout + slo_row.json)")
    ap.add_argument("--pool", default=None,
                    help="JSON file: list of ExperimentConfig template "
                         "dicts (default: the built-in two-shape pool)")
    ap.add_argument("--tenants", type=int, default=6,
                    help="number of tenants to generate from the pool")
    ap.add_argument("--rate", type=float, default=1200.0,
                    help="offered Poisson arrival rate, tenants/hour")
    ap.add_argument("--time-scale", type=float, default=1.0,
                    help="compress the arrival schedule by this factor "
                         "(0.01 = 100x faster than nominal; reported "
                         "offered rate is adjusted accordingly)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slice", type=int, default=3,
                    help="rounds per cooperative scheduling slice")
    ap.add_argument("--rounds", type=int, default=6,
                    help="rounds per tenant (built-in pool only)")
    ap.add_argument("--metrics-dir", default=None,
                    help="metrics snapshot/export dir "
                         "(default: <out>/metrics)")
    ap.add_argument("--ledger", default=None, metavar="PATH",
                    help="run-ledger file (telemetry.ledger): every "
                         "finalized tenant appends a digest row and the "
                         "service_slo row lands as the run's index entry "
                         "(default: $GOSSIPY_TPU_LEDGER)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def run(argv=None) -> tuple:
    """Run the load; returns ``(row, trace report, queue, ok)``."""
    args = parser().parse_args(argv)
    if args.pool:
        with open(args.pool) as fh:
            pool = json.load(fh)
        if not isinstance(pool, list) or not pool:
            raise SystemExit(f"--pool {args.pool}: expected a non-empty "
                             "JSON list of config dicts")
    else:
        pool = default_spec_pool(n_rounds=args.rounds)

    metrics_dir = args.metrics_dir or os.path.join(args.out, "metrics")
    tracer = Tracer(process_name="loadgen")
    ledger = resolve_ledger(args.ledger or None)
    result = run_load(args.out, pool=pool, n_tenants=args.tenants,
                      rate_per_hour=args.rate, seed=args.seed,
                      slice_rounds=args.slice, metrics_dir=metrics_dir,
                      time_scale=args.time_scale, tracing=tracer,
                      ledger=ledger, device=args.device)
    row, queue = result["row"], result["queue"]

    # The final trace and its critical-path report: the session already
    # refreshed metrics_dir/trace.json each poll cycle; save the whole
    # timeline and fold the host efficiency into the row.
    os.makedirs(metrics_dir, exist_ok=True)
    trace_path = tracer.save(os.path.join(metrics_dir, "trace.json"))
    report = trace_report(tracer.snapshot())
    report_path = os.path.join(args.out, "trace_report.json")
    with open(report_path, "w") as fh:
        json.dump(report, fh, indent=2)
        fh.write("\n")
    tot = report["totals"]
    row["raw"]["host_blocked_frac"] = tot["host_blocked_frac"]
    row["raw"]["trace_overlap_frac"] = tot["overlap_frac"]
    # The attribution's identity (host_blocked + device + unaccounted ==
    # wall holds by construction; the service loop has untraced
    # admission and build work, so only the identity is checked).
    trace_ok = (report["n_windows"] >= 1
                and tot["host_blocked_ms"] is not None
                and tot["overlap_frac"] is not None
                and abs(tot["wall_ms"] - tot["host_blocked_ms"]
                        - tot["device_ms"] - tot["unaccounted_ms"]) < 1.0)
    print(f"[loadgen] trace: {trace_path} -> {report_path} "
          f"(host_blocked {tot['host_blocked_ms']} ms, "
          f"overlap {tot['overlap_frac']:.1%}, windows "
          f"{report['n_windows']})", file=sys.stderr)
    # The backend stamp, so a trend table groups this row with its
    # hardware peers.
    dev = resolve_device(args.device)
    row["raw"]["backend"] = dev.type
    row["raw"]["device_kind"] = (torch.cuda.get_device_name(dev)
                                 if dev.type == "cuda" else "cpu")

    for h in queue.handles():
        ttfr = (f"{h.first_round_at - h.submitted_at:.3f}s"
                if h.first_round_at is not None else "MISSING")
        print(f"[loadgen] {h.tenant}: {h.status.value} "
              f"({h.rounds_completed}/{h.request.rounds} rounds) "
              f"ttfr={ttfr}", file=sys.stderr)
    raw = row["raw"]
    print(f"[loadgen] {raw['n_admitted']} admitted / "
          f"{raw['n_failed']} failed-to-build in "
          f"{raw['wall_seconds']}s -> {row['value']} tenants/hour, "
          f"ttfr p99 {raw['ttfr_p99_ms']} ms, "
          f"round p99 {raw['round_p99_ms']} ms", file=sys.stderr)
    print(f"[loadgen] metrics: {metrics_dir}/metrics.json (+ .prom); tail "
          "with: python3 -m gossipy_tpu_torch.examples.service_top "
          f"{metrics_dir}", file=sys.stderr)

    row_path = os.path.join(args.out, "slo_row.json")
    with open(row_path, "w") as fh:
        json.dump(row, fh, indent=2)
        fh.write("\n")

    if ledger is not None:
        try:
            # The run's index entry (telemetry.ledger); the per-tenant
            # rows landed at each finalize.
            lrow = ingest_slo_row(ledger, row, artifacts={
                "slo_row": row_path, "trace_report": report_path})
            print(f"[loadgen] ledger: row {lrow['run_id']} -> "
                  f"{ledger.path}", file=sys.stderr)
        except Exception as e:
            print(f"[loadgen] ledger ingest failed: {e!r}",
                  file=sys.stderr)

    # Acceptance invariant: every admitted tenant has a recorded TTFR
    # and nothing failed outright.
    ok = (not raw["ttfr_missing"]
          and raw["n_admitted"] == raw["ttfr_recorded"]
          and raw["n_failed"] == 0
          and raw["n_admitted"] == raw["n_done"] + raw["n_evicted"])
    if not ok:
        print(f"[loadgen] SLO invariant violated: "
              f"missing_ttfr={raw['ttfr_missing']} "
              f"failed={raw['n_failed']}", file=sys.stderr)
    if not trace_ok:
        print(f"[loadgen] trace invariant violated: "
              f"windows={report['n_windows']} totals={tot}",
              file=sys.stderr)
    return row, report, queue, ok and trace_ok


def main(argv=None) -> int:
    row, _, _, ok = run(argv)
    print(json.dumps(row))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
