"""service_top: live terminal status board over the SLO metrics snapshot.

Twin of the JAX package's ``scripts/service_top.py``. Tails the
``metrics.json`` a running ``serve --metrics-dir`` (or ``loadgen``)
twin refreshes every scheduling cycle and renders the service's vitals
in place: tenants admitted/finished/evicted, queue-wait /
time-to-first-round / per-round latency percentiles (the registry's own
log-bucket estimator), per-bucket init and round costs and the
per-tenant fair-share table (tenant-seconds). Reads files only (no
device work); reads are snapshot-atomic because the writer renames a
tmp file into place.

Usage::

    python3 -m gossipy_tpu_torch.examples.service_top runs/metrics          # watch (2s)
    python3 -m gossipy_tpu_torch.examples.service_top runs/metrics/metrics.json --interval 1
    python3 -m gossipy_tpu_torch.examples.service_top runs/metrics --once   # one frame
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from gossipy_tpu_torch.telemetry.metrics import quantile_from_counts


def _series(snap: dict, name: str) -> list:
    fam = snap.get("metrics", {}).get(name)
    return fam.get("series", []) if fam else []


def _counter_total(snap: dict, name: str, **labels) -> float:
    total = 0.0
    for s in _series(snap, name):
        if all(s["labels"].get(k) == v for k, v in labels.items()):
            total += s["value"]
    return total


def _counter_by(snap: dict, name: str, label: str) -> dict:
    out: dict = {}
    for s in _series(snap, name):
        key = s["labels"].get(label, "")
        out[key] = out.get(key, 0.0) + s["value"]
    return out


def _hist_pct(snap: dict, name: str, q: float, **labels):
    fam = snap.get("metrics", {}).get(name)
    if fam is None:
        return None
    counts, lo, hi = None, None, None
    for s in fam["series"]:
        if not all(s["labels"].get(k) == v for k, v in labels.items()):
            continue
        counts = (s["counts"] if counts is None
                  else [a + b for a, b in zip(counts, s["counts"])])
        if s.get("min") is not None:
            lo = s["min"] if lo is None else min(lo, s["min"])
        if s.get("max") is not None:
            hi = s["max"] if hi is None else max(hi, s["max"])
    if counts is None:
        return None
    return quantile_from_counts(fam["buckets"], counts, q, lo=lo, hi=hi)


def _ms(v) -> str:
    return f"{v * 1e3:10.1f}" if v is not None else "         -"


def host_blocked_by_bucket(snap: dict, trace_path: str) -> dict:
    """Per-bucket host-blocked percentage, bucket digest -> percent.

    Preferred source is the live trace's ``host_blocked%/<bucket>``
    counter events (the scheduler emits one per slice; the LAST event
    per bucket is the current value) — they update every slice, not
    every snapshot. Falls back to the ``service_host_blocked_frac``
    gauge in the metrics snapshot when no trace.json sits next to
    metrics.json (tracing off)."""
    out: dict = {}
    try:
        with open(trace_path) as fh:
            events = json.load(fh).get("traceEvents", [])
        last_ts: dict = {}
        for e in events:
            name = e.get("name", "")
            if e.get("ph") == "C" and name.startswith("host_blocked%/"):
                bucket = name.split("/", 1)[1]
                ts = e.get("ts", 0.0)
                if ts >= last_ts.get(bucket, -1.0):
                    last_ts[bucket] = ts
                    out[bucket] = float(e.get("args", {}).get("value", 0.0))
        if out:
            return out
    except (OSError, json.JSONDecodeError, ValueError):
        pass
    for s in _series(snap, "service_host_blocked_frac"):
        bucket = s["labels"].get("bucket", "")
        out[bucket] = float(s["value"]) * 100.0
    return out


def render(snap: dict, path: str, host_blk: dict = None) -> str:
    host_blk = host_blk or {}
    age = time.time() - snap.get("ts", 0.0)
    admitted = _counter_total(snap, "service_tenants_admitted_total")
    by_status = _counter_by(snap, "service_tenants_finished_total",
                            "status")
    finished = sum(by_status.values())
    evictions = _counter_by(snap, "service_evictions_total", "cause")
    rounds = _counter_total(snap, "service_rounds_total")

    lines = [
        f"gossipy_tpu_torch service  ·  {path}  ·  snapshot age {age:5.1f}s",
        "",
        f"tenants   admitted {int(admitted):5d}   "
        f"running {int(admitted - finished):5d}   "
        + "   ".join(f"{k} {int(v)}" for k, v in sorted(by_status.items()))
        + (f"   evictions[{', '.join(f'{k}:{int(v)}' for k, v in sorted(evictions.items()))}]"
           if evictions else ""),
        f"rounds    harvested {int(rounds)}",
        "",
        "latency (ms)        p50        p90        p99",
    ]
    for label, metric in (("queue wait", "service_queue_wait_seconds"),
                          ("ttfr", "service_ttfr_seconds"),
                          ("round", "service_round_seconds"),
                          ("slice", "service_slice_seconds")):
        lines.append(f"  {label:<14}"
                     + "".join(_ms(_hist_pct(snap, metric, q))
                               for q in (0.5, 0.9, 0.99)))

    buckets = sorted({s["labels"]["bucket"]
                      for s in _series(snap, "service_rounds_total")})
    if buckets:
        lines += ["", "bucket     rounds   round p99 (ms)  "
                      "compile init/step (s)  host blk%"]
        compile_by = {(s["labels"]["bucket"], s["labels"]["program"]):
                      s["value"]
                      for s in _series(snap, "service_compile_seconds")}
        for b in buckets[:12]:
            r = _counter_total(snap, "service_rounds_total", bucket=b)
            p99 = _hist_pct(snap, "service_round_seconds", 0.99, bucket=b)
            ci = compile_by.get((b, "init"))
            cs = compile_by.get((b, "step"))
            hb = host_blk.get(b)
            lines.append(
                f"  {b:<9}{int(r):7d} {_ms(p99)}       "
                f"{ci if ci is not None else 0:6.2f} / "
                f"{cs if cs is not None else 0:6.2f}"
                + (f"      {hb:6.1f}" if hb is not None
                   else "           -"))

    shares = [(s["labels"].get("tenant", "?"), s["value"])
              for s in _series(snap, "service_tenant_seconds_total")]
    if shares:
        total = sum(v for _, v in shares) or 1.0
        ttfr = {s["labels"].get("tenant"): s["value"]
                for s in _series(snap, "service_tenant_ttfr_seconds")}
        lines += ["", "tenant            seconds   share    ttfr (s)"]
        for name, v in sorted(shares, key=lambda x: -x[1])[:15]:
            t = ttfr.get(name)
            lines.append(f"  {name:<15}{v:9.3f}  {v / total:6.1%}"
                         f"   {t:9.3f}" if t is not None else
                         f"  {name:<15}{v:9.3f}  {v / total:6.1%}"
                         f"           -")
        if len(shares) > 15:
            lines.append(f"  ... {len(shares) - 15} more")

    engine = _counter_by(snap, "engine_rounds_total", "simulator")
    if engine:
        lines += ["", "engine    " + "   ".join(
            f"{k}: {int(v)} rounds" for k, v in sorted(engine.items()))]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="metrics dir or metrics.json path")
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--once", action="store_true",
                    help="render one frame and exit (no screen clearing)")
    args = ap.parse_args(argv)

    path = args.path
    if os.path.isdir(path):
        path = os.path.join(path, "metrics.json")

    def frame() -> str:
        try:
            with open(path) as fh:
                snap = json.load(fh)
        except FileNotFoundError:
            return f"waiting for {path} ..."
        except json.JSONDecodeError:
            return f"{path}: partial write, retrying ..."
        trace_path = os.path.join(os.path.dirname(path), "trace.json")
        return render(snap, path,
                      host_blk=host_blocked_by_bucket(snap, trace_path))

    if args.once:
        out = frame()
        print(out)
        return 1 if out.startswith("waiting for") else 0
    try:
        while True:
            # ANSI home+clear keeps the board in place without curses.
            sys.stdout.write("\x1b[H\x1b[2J" + frame() + "\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
