"""Sustained-arrival SLO harness: Poisson arrivals over a spec pool.

Counterpart of ``gossipy_tpu/service/slo.py``, with its pool, arrival
process and row schema; the library core of the ``loadgen`` twin
(``python3 -m gossipy_tpu_torch.examples.loadgen``):

- :func:`default_spec_pool`: a small mixed-shape pool (two shapes, a
  per-tenant seed and fault rate), so arrivals exercise both a bucket
  that several tenants share and one of another shape;
- :func:`poisson_arrivals`: exponential inter-arrival offsets at a
  target tenants/hour rate (deterministic under ``seed``);
- :func:`run_load`: the open loop: submit each tenant at its arrival
  time while a :class:`~gossipy_tpu_torch.service.scheduler.
  ServiceSession` keeps driving whatever is already running, so queue
  wait and time-to-first-round are measured under real contention;
- :func:`slo_row`: reduce the finished run and the metrics registry to
  the ``service_slo`` row: tenants/hour, p50/p99 time-to-first-round
  (exact, over every admitted tenant's recorded TTFR), p99 per-round
  latency (the registry histogram's estimate), with every admitted
  tenant accounted for (``ttfr_missing`` must be empty).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np

from ..config import ExperimentConfig
from ..telemetry.metrics import MetricsRegistry, get_registry
from .scheduler import GossipService
from .spec import RunQueue, RunRequest, RunStatus


def default_spec_pool(subsample: int = 400, n_rounds: int = 6) -> list:
    """Two bucket shapes' worth of config templates. ``seed`` and
    ``drop_prob`` are TENANT_VARIABLE_FIELDS: tenants generated from the
    same template pack into one bucket; the second shape (another
    population) always splits."""
    small = dict(dataset="spambase", subsample=subsample, n_nodes=16,
                 n_rounds=n_rounds, delta=20, batch_size=8,
                 topology_params={"degree": 4})
    wide = dict(dataset="spambase", subsample=subsample, n_nodes=24,
                n_rounds=n_rounds, delta=20, batch_size=8,
                topology_params={"degree": 4})
    return [small, wide]


def poisson_arrivals(n: int, rate_per_hour: float,
                     seed: int = 0) -> np.ndarray:
    """``n`` cumulative arrival offsets (seconds from load start) of a
    Poisson process at ``rate_per_hour``."""
    if rate_per_hour <= 0:
        raise ValueError(f"rate must be positive, got {rate_per_hour}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(3600.0 / rate_per_hour, size=n)
    return np.cumsum(gaps)


def make_requests(pool: Sequence[dict], n_tenants: int,
                  seed: int = 0) -> list:
    """``n_tenants`` requests drawn round-robin over the pool's shapes,
    each with its own seed and a small per-tenant drop_prob jitter (a
    tenant-variable field: same-shape tenants still share a bucket)."""
    rng = np.random.default_rng(seed + 1)
    reqs = []
    for t in range(n_tenants):
        cfg = dict(pool[t % len(pool)])
        cfg["seed"] = int(seed * 1000 + t)
        cfg.setdefault("drop_prob",
                       round(float(rng.uniform(0.0, 0.1)), 3))
        reqs.append(RunRequest(tenant=f"t{t:03d}-s{t % len(pool)}",
                               config=ExperimentConfig.from_dict(cfg)))
    return reqs


def run_load(out_dir: str, pool: Optional[Sequence[dict]] = None,
             n_tenants: int = 6, rate_per_hour: float = 3600.0,
             seed: int = 0, slice_rounds: int = 3,
             metrics_dir: Optional[str] = None,
             registry: Optional[MetricsRegistry] = None,
             time_scale: float = 1.0, tracing=None,
             ledger=None, device=None) -> dict:
    """Run the sustained-arrival load and return ``{"row": service_slo
    bench row, "summary": service summary, "queue": RunQueue}``.

    ``time_scale`` compresses the arrival schedule (0.01 = 100x faster
    than the nominal rate) so a smoke run exercises real interleaving
    without waiting out the nominal inter-arrival gaps; the reported
    ``offered_rate_per_hour`` uses the COMPRESSED schedule, so the row
    stays honest.

    ``tracing`` follows the GossipService contract (None/True/Tracer):
    when on, every arrival lands as an instant marker + queue-depth
    counter on the service's trace timeline, and the session writes
    ``trace.json`` next to ``metrics.json`` each poll cycle.

    ``ledger`` follows the same contract (telemetry.ledger.
    resolve_ledger): when on, every finalized tenant appends a digest
    row — the continuous-across-restarts SLO account.

    ``device`` is where every bucket runs (``cuda`` unless ``"cpu"`` is
    given).
    """
    reg = registry if registry is not None else get_registry()
    pool = list(pool) if pool is not None else default_spec_pool()
    svc = GossipService(out_dir, slice_rounds=slice_rounds,
                        metrics_dir=metrics_dir, registry=reg,
                        tracing=tracing, ledger=ledger, device=device)
    tracer = svc.tracer
    queue = RunQueue()
    session = svc.session(queue)
    requests = make_requests(pool, n_tenants, seed=seed)
    offsets = poisson_arrivals(n_tenants, rate_per_hour, seed=seed) \
        * float(time_scale)

    t0 = time.perf_counter()
    i = 0
    while i < len(requests) or session.any_live() or queue.pending():
        now = time.perf_counter() - t0
        while i < len(requests) and offsets[i] <= now:
            queue.submit(requests[i])
            if tracer is not None:
                tracer.instant("arrival", cat="loadgen",
                               tenant=requests[i].tenant,
                               offset_s=round(float(offsets[i]), 3))
                tracer.counter_event("loadgen.pending",
                                     value=float(len(queue.pending())))
            i += 1
        progressed = session.poll()   # admits + one slice per live bucket
        if not progressed and i < len(requests):
            # Idle until the next arrival; short naps keep the loop
            # responsive without busy-spinning the host.
            time.sleep(min(max(offsets[i] - (time.perf_counter() - t0),
                               0.0), 0.05))
    wall = time.perf_counter() - t0
    summary = session.finish()
    row = slo_row(queue, reg, wall,
                  offered_rate_per_hour=rate_per_hour / max(time_scale,
                                                            1e-12))
    return {"row": row, "summary": summary, "queue": queue}


def slo_row(queue: RunQueue, registry: MetricsRegistry, wall_seconds: float,
            offered_rate_per_hour: Optional[float] = None) -> dict:
    """The ``service_slo`` bench row (bench.py one-line contract shape).

    ``value`` is the realized service throughput in tenants/hour
    (admitted tenants that finished — DONE or EVICTED — per hour of
    wall time). TTFR percentiles are EXACT, computed over every admitted
    tenant's recorded time-to-first-round (the per-tenant gauge values);
    round-latency percentiles come from the registry histogram's
    log-bucket estimator. ``ttfr_missing`` lists any admitted tenant
    WITHOUT a recorded TTFR — the acceptance invariant is that it is
    empty, and callers exit nonzero when it is not."""
    handles = queue.handles()
    admitted = [h for h in handles
                if h.status in (RunStatus.DONE, RunStatus.EVICTED,
                                RunStatus.RUNNING)]
    finished = [h for h in handles
                if h.status in (RunStatus.DONE, RunStatus.EVICTED)]
    failed = [h for h in handles if h.status is RunStatus.FAILED]
    ttfr = [h.first_round_at - h.submitted_at for h in admitted
            if h.first_round_at is not None]
    missing = [h.tenant for h in admitted if h.first_round_at is None]
    hours = max(wall_seconds, 1e-9) / 3600.0
    tph = round(len(finished) / hours, 2)

    def pct(vals, q):
        return (round(float(np.percentile(vals, q)) * 1e3, 3)
                if vals else None)

    snap = registry.snapshot()
    round_hist = snap["metrics"].get("service_round_seconds")
    qwait_hist = snap["metrics"].get("service_queue_wait_seconds")

    def hist_pct(fam, q):
        if fam is None:
            return None
        from ..telemetry.metrics import quantile_from_counts
        counts = None
        for s in fam["series"]:
            c = s["counts"]
            counts = c if counts is None else [a + b
                                               for a, b in zip(counts, c)]
        if counts is None:
            return None
        mins = [s["min"] for s in fam["series"] if s["min"] is not None]
        maxs = [s["max"] for s in fam["series"] if s["max"] is not None]
        est = quantile_from_counts(fam["buckets"], counts, q,
                                   lo=min(mins) if mins else None,
                                   hi=max(maxs) if maxs else None)
        return round(est * 1e3, 3) if est is not None else None

    return {
        "metric": "service_slo",
        "value": tph,
        "unit": "tenants/hour",
        "raw": {
            "tenants_per_hour": tph,
            "offered_rate_per_hour": (round(offered_rate_per_hour, 2)
                                      if offered_rate_per_hour else None),
            "wall_seconds": round(wall_seconds, 3),
            "n_tenants": len(handles),
            "n_admitted": len(admitted),
            "n_done": sum(h.status is RunStatus.DONE for h in handles),
            "n_evicted": sum(h.status is RunStatus.EVICTED
                             for h in handles),
            "n_failed": len(failed),
            "ttfr_p50_ms": pct(ttfr, 50),
            "ttfr_p99_ms": pct(ttfr, 99),
            "ttfr_recorded": len(ttfr),
            "ttfr_missing": missing,
            "round_p50_ms": hist_pct(round_hist, 0.5),
            "round_p99_ms": hist_pct(round_hist, 0.99),
            "queue_wait_p99_ms": hist_pct(qwait_hist, 0.99),
        },
    }
