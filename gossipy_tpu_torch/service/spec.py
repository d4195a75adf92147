"""Run specs, handles and the queue of the gossip service.

Counterpart of ``gossipy_tpu/service/spec.py``, with its fields,
validation and messages. One process, many experiments: a tenant
describes a run as a JSON-able spec (an
:class:`~gossipy_tpu_torch.config.ExperimentConfig` plus a tenant name
and an optional round count), submits it to a :class:`RunQueue`, and
gets back a :class:`RunHandle` that follows the run through the
scheduler (queued, running, done, evicted on a sentinel trip with a
flight-recorder bundle, or failed) and, at its end, carries the tenant's
own :class:`~gossipy_tpu_torch.simulation.report.SimulationReport` and
artifact paths. The packer (:mod:`gossipy_tpu_torch.service.packer`)
groups same-shape requests into buckets; the scheduler
(:mod:`gossipy_tpu_torch.service.scheduler`) drives the buckets in turn.

Spec format (``RunRequest.from_spec``, the ``serve`` twin)::

    {"tenant": "alice-lr01",
     "config": { ... ExperimentConfig fields ... },
     "n_rounds": 200}          # optional, overrides config.n_rounds

The spec's ``config`` is strict (unknown fields raise, as in
``ExperimentConfig.from_dict``), so a mistyped knob fails at submission,
not after a bucket started.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Any, Optional

from ..config import ExperimentConfig


class RunStatus(enum.Enum):
    """Lifecycle of a tenant run inside the service."""

    QUEUED = "queued"      # submitted, not yet packed into a bucket
    RUNNING = "running"    # its bucket is being driven
    DONE = "done"          # requested rounds completed, report final
    EVICTED = "evicted"    # sentinel tripped: bundle written, lane dropped
    FAILED = "failed"      # its bucket raised (all co-tenants too)


# Simulator kinds the service does not drive (the JAX package's list and
# messages): the sequential engine is a host event loop, and PENS
# switches its round program mid-run by a host-side phase. Run these
# solo through run_experiment.
UNSERVABLE_SIMULATORS = ("sequential", "pens")


@dataclasses.dataclass
class RunRequest:
    """One tenant's run: a declarative config plus service metadata.

    ``data`` optionally overrides the config's dataset with a pre-loaded
    ``(X, y)`` tuple (the contract of
    :func:`gossipy_tpu_torch.config.build_experiment`): tenants in one
    bucket may carry entirely different data values; shapes are part of
    the packer's signature.
    """

    tenant: str
    config: ExperimentConfig
    n_rounds: Optional[int] = None   # None = config.n_rounds
    data: Optional[tuple] = None     # (X, y) override for build_experiment

    def __post_init__(self):
        if not self.tenant or "/" in self.tenant:
            raise ValueError(
                "tenant name must be a non-empty path-safe string, got "
                f"{self.tenant!r} (it names the artifact directory)")
        if self.config.simulator in UNSERVABLE_SIMULATORS:
            raise ValueError(
                f"simulator {self.config.simulator!r} cannot be served by "
                f"the megabatch scheduler ({', '.join(UNSERVABLE_SIMULATORS)}"
                " are host-phase/eager engines); run it solo via "
                "run_experiment()")
        if self.config.repetitions != 1:
            raise ValueError(
                "service runs are single-seed per tenant (submit one "
                "request per seed — the packer fuses them into one "
                "program anyway); got repetitions="
                f"{self.config.repetitions}")
        if self.config.cohort is not None:
            raise ValueError(
                "cohort mode is a host-driven resident-pool segment loop "
                "(simulation.cohort) — it cannot ride the megabatch vmap; "
                "run it solo via run_experiment()")

    @property
    def rounds(self) -> int:
        return int(self.n_rounds if self.n_rounds is not None
                   else self.config.n_rounds)

    @staticmethod
    def from_spec(spec: dict) -> "RunRequest":
        """Build a request from the JSON spec format (see module doc)."""
        unknown = set(spec) - {"tenant", "config", "n_rounds"}
        if unknown:
            raise ValueError(f"unknown spec fields: {sorted(unknown)}; "
                             "valid: tenant, config, n_rounds")
        if "tenant" not in spec or "config" not in spec:
            raise ValueError("a run spec needs 'tenant' and 'config'")
        return RunRequest(
            tenant=str(spec["tenant"]),
            config=ExperimentConfig.from_dict(dict(spec["config"])),
            n_rounds=spec.get("n_rounds"),
        )


@dataclasses.dataclass
class RunHandle:
    """Mutable per-tenant record the scheduler updates in place.

    ``report`` is the tenant's own :class:`SimulationReport` (final for
    DONE, cut at the tripped round for EVICTED, absent for FAILED);
    ``artifacts`` maps artifact names (``report``, ``manifest``,
    ``events``) to written paths; ``bundle_path`` points at the
    flight-recorder repro bundle of an evicted tenant.
    """

    request: RunRequest
    status: RunStatus = RunStatus.QUEUED
    rounds_completed: int = 0
    report: Optional[Any] = None
    bundle_path: Optional[str] = None
    error: Optional[str] = None
    bucket: Optional[str] = None          # signature digest once packed
    artifacts: dict = dataclasses.field(default_factory=dict)
    # SLO clock anchors (telemetry.metrics): stamped at submission and at
    # the first completed round, the raw material of queue wait and
    # time-to-first-round. Wall-clock epoch seconds.
    submitted_at: float = dataclasses.field(default_factory=time.time)
    first_round_at: Optional[float] = None

    @property
    def tenant(self) -> str:
        return self.request.tenant

    def to_dict(self) -> dict:
        """JSON-able summary row (the serve twin's per-tenant output)."""
        return {
            "tenant": self.tenant,
            "status": self.status.value,
            "rounds_requested": self.request.rounds,
            "rounds_completed": self.rounds_completed,
            "bucket": self.bucket,
            "bundle_path": self.bundle_path,
            "error": self.error,
            "artifacts": dict(self.artifacts),
            "submitted_at": self.submitted_at,
            "ttfr_seconds": (
                round(self.first_round_at - self.submitted_at, 6)
                if self.first_round_at is not None else None),
        }


class RunQueue:
    """FIFO submission queue: tenants submit :class:`RunRequest`\\ s, the
    scheduler takes whatever is pending when a service cycle starts.
    Host side; a service across ranks keeps one queue a rank, and rank
    0's decides what each cycle admits (``service.scheduler``): a request
    that reaches rank 0's queue first is supplied to the others
    (:meth:`supply`)."""

    def __init__(self):
        self._handles: list[RunHandle] = []
        # Handles supply() added that this queue's caller has not
        # submitted yet, oldest first.
        self._supplied: list[RunHandle] = []

    def submit(self, request: RunRequest) -> RunHandle:
        """Queue ``request``; where :meth:`supply` already queued this
        tenant's request for this caller, that handle, whatever its
        status by now."""
        for h in self._supplied:
            if h.tenant == request.tenant:
                self._supplied.remove(h)
                return h
        if any(h.tenant == request.tenant for h in self._handles
               if h.status in (RunStatus.QUEUED, RunStatus.RUNNING)):
            raise ValueError(f"tenant {request.tenant!r} already has a "
                             "queued or running request")
        handle = RunHandle(request=request)
        self._handles.append(handle)
        return handle

    def supply(self, request: RunRequest) -> RunHandle:
        """Queue ``request`` ahead of this queue's caller: on a service
        across ranks, a request rank 0's queue holds and this rank's does
        not yet. The caller's own later :meth:`submit` of the tenant
        returns this handle, so a rank whose caller lags neither queues
        the tenant twice nor refuses it."""
        handle = RunHandle(request=request)
        self._handles.append(handle)
        self._supplied.append(handle)
        return handle

    def pending(self) -> list[RunHandle]:
        return [h for h in self._handles if h.status is RunStatus.QUEUED]

    def handles(self) -> list[RunHandle]:
        return list(self._handles)
