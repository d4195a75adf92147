"""Gossip-as-a-service: a multi-tenant run scheduler on one card.

Counterpart of ``gossipy_tpu/service``, with its names. Instead of one
process driving one simulation, the service runs many concurrent
experiments ("tenants") through three pieces:

- :mod:`.spec`: :class:`RunRequest` (an
  :class:`~gossipy_tpu_torch.config.ExperimentConfig` plus a tenant name,
  the JSON spec format), :class:`RunHandle` (status, report, artifacts,
  bundle) and the :class:`RunQueue`;
- :mod:`.packer`: buckets queued runs by :class:`ShapeSignature` (config
  shape fields, the built simulator's geometry, topology content, data
  shapes), as the JAX packer does;
- :mod:`.scheduler`: :class:`GossipService`, the cooperative host-side
  control plane: round slices taken in turn across buckets, each lane its
  own simulator and state, per-tenant telemetry (JSONL, report,
  manifest), and eviction with a flight-recorder bundle on a sentinel
  trip;
- :mod:`.slo`: the sustained-arrival SLO harness.

Its command-line twins are ``gossipy_tpu_torch.examples.main_service``,
``serve``, ``loadgen`` and ``service_top``.
"""

from .packer import (
    Bucket,
    BuiltRun,
    ShapeSignature,
    build_request,
    pack,
    shape_signature,
)
from .scheduler import GossipService, ServiceSession
from .slo import (
    default_spec_pool,
    make_requests,
    poisson_arrivals,
    run_load,
    slo_row,
)
from .spec import RunHandle, RunQueue, RunRequest, RunStatus

__all__ = [
    "RunRequest", "RunHandle", "RunQueue", "RunStatus",
    "ShapeSignature", "BuiltRun", "Bucket", "shape_signature",
    "build_request", "pack",
    "GossipService", "ServiceSession",
    "default_spec_pool", "make_requests", "poisson_arrivals",
    "run_load", "slo_row",
]
