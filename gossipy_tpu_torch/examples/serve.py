"""Gossip-as-a-service CLI: JSON run specs in, per-tenant artifacts out.

Twin of the JAX package's ``scripts/serve.py``. Each spec file carries
one tenant spec or a ``{"tenants": [...]}`` list; the scheduler packs
every tenant into shape buckets, drives them in turn, and writes
per-tenant ``report.json`` / ``manifest.json`` / ``events.jsonl`` (plus a
``bundle_*/`` flight-recorder directory for a tenant evicted by its
sentinels) under ``--out/<tenant>/``, with a ``service_summary.json`` at
the root.

Spec format (see :mod:`gossipy_tpu_torch.service.spec`)::

    {"tenant": "alice-lr01",
     "config": { ... ExperimentConfig fields ... },
     "n_rounds": 200}

Stdout carries one summary JSON line (the original's keys); the
readable per-tenant table goes to stderr. Exit status: 0 when every
tenant ended DONE or EVICTED (an eviction is the service working: the
tenant's failure was isolated and its bundle written), 1 when any tenant
FAILED (its bucket raised or its spec did not build).

Usage::

    python3 -m gossipy_tpu_torch.examples.serve specs.json --out runs/
    python3 -m gossipy_tpu_torch.examples.serve all.json --out runs/ --slice 50
    python3 -m gossipy_tpu_torch.examples.serve all.json --out runs/ \\
        --metrics-dir runs/metrics
    # ... and in another terminal:
    python3 -m gossipy_tpu_torch.examples.service_top runs/metrics
"""

from __future__ import annotations

import argparse
import json
import sys

from gossipy_tpu_torch.service import GossipService, RunQueue, RunRequest, \
    RunStatus


def load_specs(paths: list) -> list:
    """Parse spec files into RunRequests (single-object or tenant-list
    files both accepted; tenant names must be unique across all files)."""
    requests = []
    for path in paths:
        with open(path) as fh:
            doc = json.load(fh)
        specs = doc["tenants"] if isinstance(doc, dict) and "tenants" in doc \
            else [doc]
        for spec in specs:
            requests.append(RunRequest.from_spec(spec))
    seen = set()
    for r in requests:
        if r.tenant in seen:
            raise ValueError(f"duplicate tenant name {r.tenant!r} across "
                             "the given specs")
        seen.add(r.tenant)
    return requests


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("specs", nargs="+", help="JSON spec file(s)")
    ap.add_argument("--out", default="service-runs",
                    help="artifact root (one subdir per tenant)")
    ap.add_argument("--slice", type=int, default=25,
                    help="rounds per cooperative scheduling slice")
    ap.add_argument("--no-repro", action="store_true",
                    help="skip per-slice last-healthy host copies "
                         "(faster; evictions lose their repro bundles)")
    ap.add_argument("--metrics-dir", default=None,
                    help="write the SLO metrics registry here: a fresh "
                         "metrics.json snapshot every scheduling cycle "
                         "(tail it with the service_top twin) plus a "
                         "final OpenMetrics metrics.prom export")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    requests = load_specs(args.specs)
    queue = RunQueue()
    handles = [queue.submit(r) for r in requests]
    svc = GossipService(args.out, slice_rounds=args.slice,
                        keep_repro=not args.no_repro,
                        metrics_dir=args.metrics_dir, device=args.device)
    summary = svc.serve(queue)

    for h in handles:
        line = (f"[serve] {h.tenant}: {h.status.value} "
                f"({h.rounds_completed}/{h.request.rounds} rounds)")
        if h.report is not None:
            try:
                acc = h.report.final("accuracy")
                line += f" accuracy={acc:.4f}"
            except Exception:
                pass
        if h.bundle_path:
            line += f" bundle={h.bundle_path}"
        if h.error:
            line += f" error={h.error}"
        print(line, file=sys.stderr)
    print(f"[serve] {summary['n_tenants']} tenant(s) in "
          f"{summary['n_buckets']} bucket(s), "
          f"{summary['wall_seconds']}s -> {summary['summary_path']}",
          file=sys.stderr)

    print(json.dumps({
        "n_tenants": summary["n_tenants"],
        "n_buckets": summary["n_buckets"],
        "megabatch_step_programs": summary["megabatch_step_programs"],
        "wall_seconds": summary["wall_seconds"],
        "tenants": {h.tenant: h.status.value for h in handles},
        "out_dir": summary["out_dir"],
    }))
    return 1 if any(h.status is RunStatus.FAILED for h in handles) else 0


if __name__ == "__main__":
    sys.exit(main())
