"""Cooperative multi-tenant scheduler: many experiments, one card.

Counterpart of ``gossipy_tpu/service/scheduler.py``: the same front door
(:class:`GossipService`, :class:`ServiceSession`), metric families,
artifacts, summary keys and failure handling. Round execution is device
work; admission, slicing, telemetry routing and failure handling live in
this host-side control plane. The scheduler:

- **packs** queued runs into shape buckets (:mod:`.packer`) and starts
  each bucket's tenants together;
- **drives** buckets in turn, one slice of ``slice_rounds`` rounds at a
  time, so a 10-tenant bucket cannot starve a 1-tenant one;
- **streams** per-tenant telemetry: each tenant gets its own JSONL event
  stream (each slice's rows replayed), its own
  :class:`~gossipy_tpu_torch.simulation.report.SimulationReport` and its
  own :class:`~gossipy_tpu_torch.telemetry.RunManifest` (seed and name
  stamped into its config block, bucket and signature into
  ``extra.service``, with cost attribution under ``extra.service.perf``:
  tenant-seconds of measured slice wall time and FLOPs from the analytic
  count of a round);
- **meters** everything into a metrics registry
  (:mod:`gossipy_tpu_torch.telemetry.metrics`), host side only: queue
  wait and per-bucket init seconds at admission, time-to-first-round per
  tenant, slice and round latency histograms, evictions by cause and
  per-tenant tenant-seconds, with the tenant's SLO record also stamped
  into its manifest (``extra.service.slo``); an incremental
  :class:`ServiceSession` (admit, poll, finish) lets tenants arrive while
  buckets are mid-flight (the SLO harness, :mod:`.slo`, drives it open
  loop);
- **survives tenant failure**: each slice's start states and draw states
  are kept on the host as last-healthy copies; when a tenant's
  ``health_trip`` sentinel fires, the scheduler writes that tenant's
  flight-recorder bundle from them and evicts the tenant (its handle says
  ``EVICTED``, its report stops at the tripped round) while its
  co-tenants run on untouched.

**How a bucket runs.** The JAX service runs a bucket as one ``vmap`` of
a compiled scan over the tenant axis, rebinding one representative
simulator's data, fault rates and chaos schedule per lane. The port
compiles nothing and its simulator keeps per-tenant tables (the chaos
tables, the draw provider and its neighbour lists, the sentinels' carry),
so a lane is its own built simulator and its own state: a slice advances
each live lane in turn by ``slice_rounds`` rounds through the engine's
own loop (``_run_rounds``; the slice's last round is the run's last, as
in the JAX scan) and copies its rows to the host once. Every live lane
runs the whole slice, its rows past the requested rounds dropped, as in
the JAX service; an evicted lane is no longer stepped (the JAX lane keeps
computing and nothing reads it).

Chunk-boundary note: as in every chunked runner, a slice's final round
counts as a segment-final round, which under ``eval_every > 1``
evaluates where one continuous run would not: tenant curves can carry
those extra eval rows.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..checkpoint import draw_record, slice_lane
from ..simulation.events import JSONLinesReceiver, SimulationEventSender
from ..telemetry import RunManifest, emit_event
from ..telemetry import tracing as _tracing
from ..telemetry.cost import analytic_round_cost
from ..telemetry.health import FlightRecorder
from ..telemetry.metrics import MetricsRegistry, get_registry
from .packer import Bucket, BuiltRun, build_request, pack
from .spec import RunQueue, RunStatus


def _service_metrics(reg: MetricsRegistry) -> dict:
    """Get-or-create the scheduler's metric families on ``reg`` (the JAX
    service's names, labels and help). Idempotent: the registry's family
    accessors are get-or-create by name."""
    return {
        "admitted": reg.counter(
            "service_tenants_admitted_total",
            "tenants packed into a bucket", ("bucket",)),
        "finished": reg.counter(
            "service_tenants_finished_total",
            "tenants that left the service, by final status",
            ("status",)),
        "evictions": reg.counter(
            "service_evictions_total",
            "tenants evicted/failed mid-run, by cause", ("cause",)),
        "queue_wait": reg.histogram(
            "service_queue_wait_seconds",
            "submission -> bucket admission wait", ("bucket",)),
        "ttfr": reg.histogram(
            "service_ttfr_seconds",
            "submission -> first completed round (time-to-first-round)"),
        "ttfr_tenant": reg.gauge(
            "service_tenant_ttfr_seconds",
            "per-tenant time-to-first-round", ("tenant",)),
        "compile": reg.gauge(
            "service_compile_seconds",
            "bucket program build+compile wall seconds",
            ("bucket", "program")),
        "slice": reg.histogram(
            "service_slice_seconds",
            "one cooperative slice's wall seconds", ("bucket",)),
        "round": reg.histogram(
            "service_round_seconds",
            "per-round latency (slice wall / rounds in slice)",
            ("bucket",)),
        "rounds": reg.counter(
            "service_rounds_total",
            "tenant-rounds harvested", ("bucket",)),
        "tenant_seconds": reg.counter(
            "service_tenant_seconds_total",
            "per-tenant share of measured bucket wall time "
            "(the fair-share currency)", ("tenant",)),
        "host_blocked": reg.gauge(
            "service_host_blocked_frac",
            "fraction of the bucket's cumulative slice wall spent in "
            "host-side work (trace-derived; compile + harvest + repro "
            "copies vs the device execution wait)", ("bucket",)),
    }


class _TenantSender(SimulationEventSender):
    """Per-tenant receiver host: each slice's rows are replayed through
    this sender to the tenant's receivers (JSONL by default)."""


def _rows_to_host(sim, rows: list) -> dict:
    """A lane's per-round stats rows (``_run_rounds``) as host arrays,
    one stacked copy a field, as the engine's ``_finish_run`` makes
    them."""
    return {k: torch.stack([torch.as_tensor(row[k], device=sim.device)
                            for row in rows]).cpu().numpy()
            for k in rows[0]}


class _BucketRuntime:
    """One bucket's life: a built simulator and a state per lane, the
    per-slice harvest loop, completion and failure."""

    def __init__(self, bucket: Bucket, out_root: str, slice_rounds: int,
                 keep_repro: bool, events_jsonl: bool,
                 registry: Optional[MetricsRegistry] = None,
                 mesh=None, tracer=None, ledger=None):
        self.bucket = bucket
        self.mesh = mesh
        # The bucket's placement on the mesh (batch_dims=1: the node axis
        # past the lane axis), from the rule registry; None without one.
        self.placement = self.data_placement = None
        # Run ledger (telemetry.ledger), shared across the session's
        # buckets: every finalized tenant appends one digest row.
        self.ledger = ledger
        self._reg = registry if registry is not None else get_registry()
        self._m = _service_metrics(self._reg)
        self._digest8 = bucket.signature.digest[:8]
        # Host span tracer (telemetry.tracing), shared across the
        # session's buckets: slice and init spans, the tenant lifecycle
        # async track, and the host-blocked accounting below.
        self.tracer = tracer
        self._hb_host = 0.0   # cumulative non-wait host seconds
        self._hb_wall = 0.0   # cumulative slice wall seconds
        self._queue_wait: dict[int, float] = {}
        runs = bucket.runs
        self.sim = runs[0].sim  # the signature's representative
        self.slice_rounds = int(slice_rounds)
        self.keep_repro = keep_repro
        self.sentinels_on = self.sim.sentinels is not None
        self.requested = [r.request.rounds for r in runs]
        self.total_rounds = max(self.requested)
        self.rounds_done = 0
        self.live = True
        self.states: list = []
        # Lane i's last healthy (state, draw record) on the host.
        self._healthy: dict[int, tuple] = {}
        self._healthy_round = 0
        self._accum: list[list[dict]] = [[] for _ in runs]
        # Per-tenant cost attribution (telemetry.cost): the wall seconds
        # of the bucket's slices split evenly across the live lanes, and
        # FLOPs = the analytic count of one round of the bucket's shape
        # times the rounds the tenant took.
        self._tenant_seconds = [0.0] * len(runs)
        self._tenant_flops = [0.0] * len(runs)
        self._step_cost: Optional[dict] = None
        self.metric_names = self.sim._metric_keys()

        self.out_dirs: dict[int, str] = {}
        self._senders: list[_TenantSender] = []
        self._receivers: list[Optional[JSONLinesReceiver]] = []
        for i, r in enumerate(runs):
            d = os.path.join(out_root, r.tenant)
            os.makedirs(d, exist_ok=True)
            self.out_dirs[i] = d
            sender = _TenantSender()
            rx = None
            if events_jsonl:
                path = os.path.join(d, "events.jsonl")
                rx = JSONLinesReceiver(path)
                sender.add_receiver(rx)
                r.handle.artifacts["events"] = path
            self._senders.append(sender)
            self._receivers.append(rx)

    # -- lanes ---------------------------------------------------------------

    def _init_lane(self, i: int):
        """Lane ``i``'s round-0 state: its simulator's ``init_nodes``
        under the run's init generator, as ``run_experiment`` starts a
        solo run."""
        run = self.bucket.runs[i]
        return run.sim.init_nodes(
            run.key, common_init=run.request.config.common_init)

    def initialize(self) -> None:
        t_adm = time.time()
        for i, r in enumerate(self.bucket.runs):
            # Queue wait: submission -> this bucket starting its lanes.
            wait = max(t_adm - r.handle.submitted_at, 0.0)
            self._queue_wait[i] = wait
            self._m["queue_wait"].labels(bucket=self._digest8).observe(wait)
            if self.tracer is not None:
                # The tenant's lifecycle async track opens at admission;
                # first-round and finish markers land in step()/_finalize.
                self.tracer.begin_async(
                    "tenant", aid=r.tenant, bucket=self._digest8,
                    queue_wait_s=round(wait, 3))
        self._m["admitted"].labels(bucket=self._digest8).inc(
            self.bucket.size)
        # The span handle is the one timing source: it feeds both the
        # init gauge and the trace.
        sp_i = _tracing.span("service.init", cat="service",
                             tracer=self.tracer, bucket=self._digest8,
                             program="init")
        with sp_i:
            self.states = [self._init_lane(i)
                           for i in range(self.bucket.size)]
            if self.mesh is not None:
                self._place_on_mesh()
            if self.sim.device.type == "cuda":
                torch.cuda.synchronize(self.sim.device)
        self._m["compile"].labels(bucket=self._digest8,
                                  program="init").set_value(sp_i.duration)
        # The analytic count of one round (on meta tensors: no draw, no
        # launch), banked once for the bucket's FLOP attribution.
        self._step_cost = analytic_round_cost(self.sim)
        for r in self.bucket.runs:
            r.handle.status = RunStatus.RUNNING
        emit_event("service_bucket_start", {
            "bucket": self.bucket.signature.digest,
            "tenants": self.bucket.tenants,
            "slice_rounds": self.slice_rounds,
            "total_rounds": self.total_rounds,
        })

    def _place_on_mesh(self) -> None:
        """Each lane's state and data placed per the rule registry (whole
        tensors on a virtual mesh's device, their placement recorded), and
        the bucket's ``[T, ...]`` placement with ``batch_dims=1``."""
        from .. import parallel
        from ..parallel import rules

        def batched(tree):
            t = len(self.states)
            return rules.tree_map_with_path(
                lambda _, x: (torch.empty((t,) + tuple(x.shape),
                                          dtype=x.dtype, device="meta")
                              if isinstance(x, torch.Tensor) else x), tree)

        self.states = [parallel.shard_state(s, self.mesh)
                       for s in self.states]
        for r in self.bucket.runs:
            r.sim.data = parallel.shard_data(r.sim.data, self.mesh)
        self.placement = parallel.state_shardings(
            batched(self.states[0]), self.mesh, batch_dims=1)
        self.data_placement = rules.named_shardings(
            batched(self.sim.data), self.mesh, rules=parallel.DATA_RULES,
            batch_dims=1)

    # -- slice driving -----------------------------------------------------

    def _live_lanes(self) -> list[int]:
        return [i for i, r in enumerate(self.bucket.runs)
                if r.handle.status is RunStatus.RUNNING]

    def _run_lanes(self, lanes: list) -> dict:
        """Advance each live lane by one slice through its simulator's
        round loop; lane -> its rows on the host."""
        host = {}
        for i in lanes:
            sim = self.bucket.runs[i].sim
            rows = sim._run_rounds(self.states[i], self.slice_rounds)
            host[i] = _rows_to_host(sim, rows)
        return host

    def step(self) -> None:
        """Advance every live tenant by one slice, harvest per-tenant
        rows, and handle completions and evictions."""
        lanes = self._live_lanes()
        if not lanes:
            self.live = False
            return
        chunk_start = self.rounds_done
        # The slice is one trace run window (round_start/rounds args are
        # what trace_report reduces on).
        sp_slice = _tracing.span("service.slice", cat="service",
                                 tracer=self.tracer, bucket=self._digest8,
                                 round_start=chunk_start,
                                 rounds=self.slice_rounds)
        with sp_slice:
            if self.keep_repro:
                # Host copies of each lane's state and draw state: the
                # bundle's checkpoint if this slice trips the lane.
                with _tracing.span("service.snapshot_healthy",
                                   cat="service", tracer=self.tracer):
                    self._healthy = {
                        i: (slice_lane(self.states, i),
                            draw_record(self.bucket.runs[i].sim.draws))
                        for i in lanes}
                self._healthy_round = self.rounds_done
            # cat="host.wait": the lanes' launches and the host copies
            # that wait for them; the bridged device span below accounts
            # the window.
            sp_step = _tracing.span("service.step", cat=_tracing.WAIT_CAT,
                                    tracer=self.tracer)
            try:
                with sp_step:
                    host = self._run_lanes(lanes)
            except Exception as e:  # a lane raised: the bucket fails
                self._fail_all(e, chunk_start)
                return
            if self.tracer is not None:
                _tracing.attach_device_spans(
                    self.tracer, sp_step.ts_us, sp_step.dur_us,
                    args={"bucket": self._digest8})
            # The host copies inside the step span wait for the card, so
            # the step's wall is the slice's real cost, split evenly
            # across the live lanes.
            slice_wall = sp_step.duration
            self._m["slice"].labels(bucket=self._digest8).observe(
                slice_wall)
            self._m["round"].labels(bucket=self._digest8).observe(
                slice_wall / max(self.slice_rounds, 1))
            per_lane_round_flops = (
                self._step_cost["flops_per_round"]
                if self._step_cost is not None
                and self._step_cost.get("flops_per_round") else None)
            self.rounds_done += self.slice_rounds

            sp_h = _tracing.span("service.harvest", cat="service",
                                 tracer=self.tracer, bucket=self._digest8)
            with sp_h:
                for i in lanes:
                    run = self.bucket.runs[i]
                    h = run.handle
                    take = min(self.slice_rounds,
                               self.requested[i] - h.rounds_completed)
                    rows = {k: v[:take] for k, v in host[i].items()}
                    trip_idx = None
                    if self.sentinels_on and "health_trip" in rows:
                        nz = np.nonzero(
                            np.asarray(rows["health_trip"]) > 0)[0]
                        trip_idx = int(nz[0]) if nz.size else None
                    self._tenant_seconds[i] += slice_wall / len(lanes)
                    self._m["tenant_seconds"].labels(
                        tenant=run.tenant).inc(slice_wall / len(lanes))
                    if h.rounds_completed == 0 and take > 0:
                        # Time-to-first-round: the tenant's first
                        # completed round became observable when this
                        # slice's results landed.
                        h.first_round_at = time.time()
                        ttfr = max(h.first_round_at - h.submitted_at, 0.0)
                        self._m["ttfr"].observe(ttfr)
                        self._m["ttfr_tenant"].labels(
                            tenant=run.tenant).set_value(ttfr)
                        if self.tracer is not None:
                            self.tracer.async_instant(
                                "first_round", aid=run.tenant,
                                ttfr_s=round(ttfr, 3))
                    if per_lane_round_flops is not None:
                        rounds_taken = (take if trip_idx is None
                                        else trip_idx + 1)
                        self._tenant_flops[i] += \
                            per_lane_round_flops * rounds_taken
                    if trip_idx is not None:
                        rows = {k: v[:trip_idx + 1]
                                for k, v in rows.items()}
                        self._harvest_rows(i, rows, chunk_start)
                        h.rounds_completed += trip_idx + 1
                        self._m["rounds"].labels(
                            bucket=self._digest8).inc(trip_idx + 1)
                        self._evict(i, chunk_start + trip_idx, rows)
                    else:
                        self._harvest_rows(i, rows, chunk_start)
                        h.rounds_completed += take
                        self._m["rounds"].labels(
                            bucket=self._digest8).inc(take)
                        if h.rounds_completed >= self.requested[i]:
                            self._finalize(i, RunStatus.DONE)
        # Per-bucket host-blocked accounting (the service_top column and
        # the trace counter track): everything in the window but the
        # lanes' step is host work; nothing in this loop overlaps the
        # card, so blocked == host-busy.
        self._hb_wall += sp_slice.duration
        self._hb_host += max(sp_slice.duration - sp_step.duration, 0.0)
        if self._hb_wall > 0:
            frac = self._hb_host / self._hb_wall
            self._m["host_blocked"].labels(
                bucket=self._digest8).set_value(round(frac, 4))
            if self.tracer is not None:
                self.tracer.counter_event(
                    f"host_blocked%/{self._digest8}",
                    value=round(frac * 100.0, 2))
        if not self._live_lanes():
            self.live = False

    def _harvest_rows(self, i: int, rows: dict, chunk_start: int) -> None:
        """Keep one tenant's slice rows and stream them out: replay
        through the tenant's receivers (JSONL) and mirror a tagged
        per-round event into the process sink (trailing context for
        bundles; filter with ``events(where=...)``)."""
        if rows["sent"].shape[0] == 0:
            return
        run = self.bucket.runs[i]
        self._accum[i].append(rows)
        sender = self._senders[i]
        if sender._receivers_list():
            sender.replay_events(chunk_start, rows, self.metric_names,
                                 fire_end=False)
        trips = rows.get("health_trip")
        for j in range(rows["sent"].shape[0]):
            emit_event("round", {
                "tenant": run.tenant,
                "round": chunk_start + j + 1,
                "sent": int(rows["sent"][j]),
                "failed": int(rows["failed"][j]),
                "trip": bool(trips[j]) if trips is not None else False,
            })

    # -- completion / failure ----------------------------------------------

    def _tenant_stats(self, i: int) -> Optional[dict]:
        chunks = self._accum[i]
        if not chunks:
            return None
        return {k: np.concatenate([c[k] for c in chunks], axis=0)
                for k in chunks[0]}

    def _build_tenant_report(self, i: int):
        stats = self._tenant_stats(i)
        if stats is None:
            return None
        # The lane's own simulator holds the tenant's fault rates, which
        # the report's host-side fields (probe expected fan-in) read.
        return self.bucket.runs[i].sim._build_report(
            stats, int(stats["sent"].shape[0]))

    def _tenant_manifest(self, i: int) -> RunManifest:
        run = self.bucket.runs[i]
        cfg = run.request.config
        h = run.handle
        return RunManifest.from_simulator(
            run.sim,
            extra={"service": {
                "tenant": run.tenant,
                "bucket": self.bucket.signature.digest,
                "bucket_tenants": self.bucket.tenants,
                "bucket_size": self.bucket.size,
                "signature": self.bucket.signature.summary,
                "slice_rounds": self.slice_rounds,
                "rounds_requested": self.requested[i],
                "rounds_completed": h.rounds_completed,
                "status": h.status.value,
                # The port compiles nothing: no compilation cache.
                "bucket_compilation_cache": None,
                # Cost attribution for this tenant: its share of the
                # bucket's measured wall time and its FLOPs from the
                # analytic count (None where the handler resists it).
                "perf": {
                    "tenant_seconds": round(self._tenant_seconds[i], 6),
                    "tenant_flops_est": (self._tenant_flops[i]
                                         if self._step_cost is not None
                                         else None),
                    "step_program": self._step_cost,
                },
                # This tenant's SLO record (telemetry.metrics), carried
                # with the tenant; the bucket's round-latency
                # percentiles come from the registry's estimator.
                "slo": self._tenant_slo(i),
            }},
            config_overrides={"drop_prob": cfg.drop_prob,
                              "online_prob": cfg.online_prob,
                              "seed": cfg.seed,
                              "tenant": run.tenant})

    def _tenant_slo(self, i: int) -> dict:
        run = self.bucket.runs[i]
        h = run.handle
        rh = self._m["round"].labels(bucket=self._digest8)
        ttfr = (h.first_round_at - h.submitted_at
                if h.first_round_at is not None else None)
        return {
            "queue_wait_seconds": round(self._queue_wait.get(i, 0.0), 6),
            "ttfr_seconds": round(ttfr, 6) if ttfr is not None else None,
            "tenant_seconds": round(self._tenant_seconds[i], 6),
            "rounds_completed": h.rounds_completed,
            "bucket_round_seconds_p50": rh.quantile(0.5),
            "bucket_round_seconds_p99": rh.quantile(0.99),
        }

    def _finalize(self, i: int, status: RunStatus) -> None:
        run = self.bucket.runs[i]
        h = run.handle
        h.status = status
        self._m["finished"].labels(status=status.value).inc()
        if self.tracer is not None:
            # Close the lifecycle async track opened at admission.
            self.tracer.end_async("tenant", aid=run.tenant,
                                  status=status.value,
                                  rounds=h.rounds_completed)
        h.report = self._build_tenant_report(i)
        out = self.out_dirs[i]
        if h.report is not None:
            path = os.path.join(out, "report.json")
            h.report.save(path)
            h.artifacts["report"] = path
        path = os.path.join(out, "manifest.json")
        manifest = self._tenant_manifest(i)
        manifest.save(path)
        h.artifacts["manifest"] = path
        self._ledger_append(i, manifest)
        self._senders[i]._notify_end()
        rx = self._receivers[i]
        if rx is not None:
            rx.close()
            self._receivers[i] = None

    def _ledger_append(self, i: int, manifest: RunManifest) -> None:
        """One digest row per finalized tenant (telemetry.ledger; no-op
        without a ledger): status, SLO percentiles and hashed artifact
        paths, with the tenant's own ExperimentConfig under
        ``experiment``. Best-effort: a ledger problem never fails a
        finalize."""
        if self.ledger is None:
            return
        try:
            import dataclasses

            from ..telemetry import ledger as _ledger
            run = self.bucket.runs[i]
            h = run.handle
            slo = self._tenant_slo(i)
            p50 = slo.get("bucket_round_seconds_p50")
            p99 = slo.get("bucket_round_seconds_p99")
            metrics = {
                "slo_p50_ms": p50 * 1000.0 if p50 is not None else None,
                "slo_p99_ms": p99 * 1000.0 if p99 is not None else None,
            }
            if h.report is not None:
                for name in ("accuracy", "auc", "f1"):
                    acc = h.report.final(name)
                    if acc == acc:
                        metrics["final_accuracy"] = acc
                        break
            failure = None
            if h.status is not RunStatus.DONE:
                failure = {"kind": h.status.value, "error": h.error}
                if h.bundle_path:
                    failure["bundle"] = h.bundle_path
            _ledger.ingest_manifest(
                self.ledger, manifest, kind="tenant",
                metrics=metrics, failure=failure,
                artifacts=dict(h.artifacts),
                experiment=dataclasses.asdict(run.request.config),
                extra={"tenant": run.tenant,
                       "bucket": self.bucket.signature.digest,
                       "status": h.status.value,
                       "rounds_completed": h.rounds_completed,
                       "slo": slo})
        except Exception:
            pass

    def _evict(self, i: int, bad_round: int, rows: dict) -> None:
        """Sentinel trip: write the tenant's repro bundle from its last
        healthy state and draw state, and stop stepping its lane
        (co-tenants are untouched)."""
        run = self.bucket.runs[i]
        h = run.handle
        detail: dict = {"tenant": run.tenant,
                        "bucket": self.bucket.signature.digest}
        nf = rows.get("health_nonfinite_params")
        if nf is not None and len(nf):
            detail["nonfinite_params_total"] = int(np.asarray(nf[-1]).sum())
        div = rows.get("health_diverged_per_node")
        if div is not None and len(div):
            detail["diverged_nodes"] = int((np.asarray(div[-1]) > 0).sum())
        if self.keep_repro and i in self._healthy:
            state, draws = self._healthy[i]
            rec = FlightRecorder(self.out_dirs[i])
            h.bundle_path = rec.write_bundle(
                run.sim, state, draws, "sentinel", self._healthy_round,
                first_bad_round=bad_round, detail=detail,
                rounds_recorded=h.rounds_completed)
        self._m["evictions"].labels(cause="sentinel").inc()
        emit_event("tenant_evicted", {
            "tenant": run.tenant,
            "bucket": self.bucket.signature.digest,
            "first_bad_round": bad_round,
            "bundle_path": h.bundle_path,
        })
        self._finalize(i, RunStatus.EVICTED)

    def _fail_all(self, error: Exception, chunk_start: int) -> None:
        """A lane's round raised: every live tenant of the bucket fails
        together, each with an exception bundle from its last healthy
        state. Other buckets are unaffected: the service loop keeps
        driving them."""
        self.live = False
        for i in self._live_lanes():
            run = self.bucket.runs[i]
            h = run.handle
            h.error = repr(error)[:500]
            self._m["evictions"].labels(cause="exception").inc()
            if self.keep_repro and i in self._healthy:
                state, draws = self._healthy[i]
                rec = FlightRecorder(self.out_dirs[i])
                try:
                    h.bundle_path = rec.write_bundle(
                        run.sim, state, draws, "exception",
                        self._healthy_round,
                        detail={"error": h.error, "tenant": run.tenant},
                        rounds_recorded=h.rounds_completed)
                except Exception:  # the bundle is best-effort forensics
                    pass
            self._finalize(i, RunStatus.FAILED)
        emit_event("bucket_failed", {
            "bucket": self.bucket.signature.digest,
            "error": repr(error)[:500],
            "tenants": self.bucket.tenants,
        })

    def summary(self) -> dict:
        # The JAX summary's keys. The port compiles nothing: no
        # compilation cache and no jit caches to count.
        return {
            "bucket": self.bucket.signature.digest,
            "tenants": self.bucket.tenants,
            "size": self.bucket.size,
            "slice_rounds": self.slice_rounds,
            "slices": math.ceil(self.rounds_done / self.slice_rounds),
            "rounds_driven": self.rounds_done,
            "compilation_cache": None,
            "signature": self.bucket.signature.summary,
            "init_jit_cache_size": None,
            "step_jit_cache_size": None,
        }


class GossipService:
    """Gossip-as-a-service front door: build, pack, schedule, report.

    Usage::

        svc = GossipService(out_dir="runs", slice_rounds=25)
        q = RunQueue()
        h1 = q.submit(RunRequest("alice", cfg_a))
        h2 = q.submit(RunRequest("bob", cfg_b))
        summary = svc.serve(q)          # drains everything pending
        h1.report.final("accuracy")     # per-tenant results

    ``slice_rounds`` is the cooperative quantum: buckets advance in turn
    one slice at a time. ``keep_repro=False`` skips the per-slice host
    copies (faster slicing, but evictions lose their repro bundles).
    Every bucket runs on ``device`` (``cuda`` unless ``"cpu"`` is
    given). ``mesh=`` (a virtual mesh on ``device``,
    :mod:`gossipy_tpu_torch.parallel`) builds each lane's simulator with
    that mesh (its deliver a ring over the node axis), places each lane's
    state and data per the partition-rule registry, and records the
    bucket's placement with ``batch_dims=1`` (``_BucketRuntime.placement``
    and ``data_placement``: the node axis past the lane axis).
    """

    def __init__(self, out_dir: str, slice_rounds: int = 25,
                 keep_repro: bool = True, sentinels_default: bool = True,
                 events_jsonl: bool = True,
                 metrics_dir: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None,
                 mesh=None, tracing=None, ledger=None, device=None):
        self.device = resolve_device(device)
        if mesh is not None:
            from ..parallel import _ACROSS_CARDS, canonical_device
            if not mesh.is_virtual() or mesh.device() != canonical_device(
                    self.device):
                raise NotImplementedError(_ACROSS_CARDS)
        self.mesh = mesh
        self.out_dir = os.path.abspath(out_dir)
        os.makedirs(self.out_dir, exist_ok=True)
        self.slice_rounds = int(slice_rounds)
        if self.slice_rounds < 1:
            raise ValueError(f"slice_rounds must be >= 1, got "
                             f"{self.slice_rounds}")
        self.keep_repro = bool(keep_repro)
        self.sentinels_default = bool(sentinels_default)
        self.events_jsonl = bool(events_jsonl)
        self.metrics_dir = (os.path.abspath(metrics_dir)
                            if metrics_dir else None)
        self.registry = registry if registry is not None else get_registry()
        # Host span tracing (telemetry.tracing), the engine's contract:
        # None/False off, True the process-default tracer, or a Tracer.
        # When on, every poll cycle also writes trace.json next to
        # metrics.json (the service_top twin reads both).
        if tracing is None or tracing is False:
            self.tracer = None
        elif tracing is True:
            self.tracer = _tracing.ensure_tracer()
        else:
            self.tracer = tracing
        # Run ledger (telemetry.ledger), the engine's contract: None
        # reads GOSSIPY_TPU_LEDGER, False off, a path or RunLedger
        # explicit; every finalized tenant appends one digest row.
        from ..telemetry.ledger import resolve_ledger
        self.ledger = resolve_ledger(ledger)

    def run(self, requests: list) -> dict:
        """Serve a fixed batch of requests (sugar over :meth:`serve`)."""
        q = RunQueue()
        for r in requests:
            q.submit(r)
        return self.serve(q)

    def session(self, queue: RunQueue) -> "ServiceSession":
        """Open an incremental serving session over ``queue``: tenants
        may be submitted while earlier buckets are mid-flight; each
        :meth:`ServiceSession.poll` packs whatever is newly pending into
        fresh buckets and advances every live bucket one slice."""
        return ServiceSession(self, queue)

    def serve(self, queue: RunQueue) -> dict:
        """Drain everything pending in ``queue``: build each request, pack
        into shape buckets, drive all buckets to completion, write
        per-tenant artifacts plus a ``service_summary.json``. Returns the
        summary dict; per-tenant state lives on the queue's handles."""
        session = self.session(queue)
        while session.poll():
            pass
        return session.finish()


class ServiceSession:
    """One incremental serving run: admission, cooperative driving and
    metrics snapshots, decoupled so arrivals can interleave with
    progress:

    - :meth:`poll`: admit whatever the queue holds as QUEUED (build,
      pack, start new buckets; running buckets are untouched), then
      advance every live bucket by one slice. Returns True while
      anything is still live. Writes a fresh registry snapshot to the
      service's ``metrics_dir`` each cycle.
    - :meth:`finish`: per-tenant artifacts are already on disk (written
      at each tenant's finalize); this writes ``service_summary.json``
      plus the final metrics snapshot and OpenMetrics export and returns
      the summary dict.

    Queue wait and time-to-first-round are measured against each
    handle's ``submitted_at``, so a tenant that waited behind running
    buckets carries its real wait."""

    def __init__(self, service: GossipService, queue: RunQueue):
        self.service = service
        self.queue = queue
        self.runtimes: list[_BucketRuntime] = []
        self.t0 = time.time()
        if service.metrics_dir:
            os.makedirs(service.metrics_dir, exist_ok=True)

    # -- admission ---------------------------------------------------------

    def admit_pending(self) -> int:
        """Build and pack every QUEUED handle into new buckets and start
        them. Returns how many tenants were admitted. A spec that fails
        to build fails alone, without disturbing anything running."""
        svc = self.service
        built: list[BuiltRun] = []
        for h in self.queue.pending():
            try:
                built.append(build_request(
                    h.request, handle=h,
                    sentinels_default=svc.sentinels_default,
                    device=svc.device, mesh=svc.mesh))
            except Exception as e:
                h.status = RunStatus.FAILED
                h.error = repr(e)[:500]
        if not built:
            return 0
        buckets = pack(built)
        emit_event("service_packed", {
            "tenants": [b.tenant for b in built],
            "buckets": [{"bucket": b.signature.digest,
                         "tenants": b.tenants} for b in buckets],
        })
        new = [_BucketRuntime(b, svc.out_dir, svc.slice_rounds,
                              svc.keep_repro, svc.events_jsonl,
                              registry=svc.registry, mesh=svc.mesh,
                              tracer=svc.tracer, ledger=svc.ledger)
               for b in buckets]
        for rt in new:
            rt.initialize()
        self.runtimes.extend(new)
        return len(built)

    # -- driving -----------------------------------------------------------

    def any_live(self) -> bool:
        return any(rt.live for rt in self.runtimes)

    def poll(self) -> bool:
        """One cooperative cycle: admit arrivals, advance each live
        bucket one slice, refresh the metrics snapshot. Returns True
        while any bucket is still live (callers loop on it)."""
        self.admit_pending()
        for rt in self.runtimes:
            if rt.live:
                rt.step()
        self._write_metrics()
        return self.any_live()

    def _write_metrics(self) -> None:
        if self.service.metrics_dir:
            self.service.registry.save(
                os.path.join(self.service.metrics_dir, "metrics.json"))
            if self.service.tracer is not None:
                # Atomic like metrics.json: a tailing service_top never
                # reads a torn trace.
                self.service.tracer.save(
                    os.path.join(self.service.metrics_dir, "trace.json"))

    # -- completion --------------------------------------------------------

    def finish(self) -> dict:
        svc = self.service
        summary = {
            "out_dir": svc.out_dir,
            "wall_seconds": round(time.time() - self.t0, 3),
            "slice_rounds": svc.slice_rounds,
            "n_tenants": len(self.queue.handles()),
            "n_buckets": len(self.runtimes),
            # One round program per bucket in the JAX service; here the
            # bucket count, the key its twins check.
            "megabatch_step_programs": len(self.runtimes),
            "compilation_cache": None,
            "buckets": [rt.summary() for rt in self.runtimes],
            "tenants": [h.to_dict() for h in self.queue.handles()],
        }
        path = os.path.join(svc.out_dir, "service_summary.json")
        with open(path, "w") as fh:
            json.dump(summary, fh, indent=2, default=str)
            fh.write("\n")
        summary["summary_path"] = path
        if svc.metrics_dir:
            self._write_metrics()
            om = os.path.join(svc.metrics_dir, "metrics.prom")
            with open(om, "w") as fh:
                fh.write(svc.registry.to_openmetrics())
            summary["metrics_dir"] = svc.metrics_dir
        emit_event("service_done", {
            "n_tenants": summary["n_tenants"],
            "n_buckets": summary["n_buckets"],
            "wall_seconds": summary["wall_seconds"],
        })
        return summary
