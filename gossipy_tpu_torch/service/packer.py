"""Shape packing: bucket queued runs by the shape of their round.

Counterpart of ``gossipy_tpu/service/packer.py``, with its signature
fields and bucketing rule. Two runs share a bucket exactly when their
rounds have the same shapes: the config's
:meth:`~gossipy_tpu_torch.config.ExperimentConfig.shape_fields` (model
and handler constants, topology spec, protocol, mailbox knobs,
probes/sentinels), plus facts only the built simulator knows: the
derived mailbox slots ``K``, the delay model (which sets the ring depth
``D``), the ring format, the topology's actual edges (two seeds that
built different graphs never share a bucket) and the stacked data's
shapes and dtypes. What may differ inside a bucket is the seed, the data
values, the fault rates, the chaos schedule's values and the requested
round count.

The JAX service compiles one program a bucket and runs its tenants as
the lanes of one ``vmap``. The port compiles nothing: each tenant keeps
its own built simulator and state (the scheduler steps the lanes of a
bucket in turn), and the signature decides the buckets as the JAX packer
does, so both packages partition the same requests alike.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import zlib
from typing import Any, Optional

import numpy as np
import torch

from .spec import RunHandle, RunRequest


@dataclasses.dataclass(frozen=True)
class ShapeSignature:
    """A bucket key: the digest plus the readable field dict it hashes
    (stamped into run summaries and per-tenant manifests, so which
    tenants shared a bucket can be audited)."""

    digest: str
    summary: dict

    def __str__(self) -> str:
        return self.digest


@dataclasses.dataclass
class BuiltRun:
    """A request built into a live simulator: the packer's unit of work.
    ``sim`` is the tenant's own simulator (its data, fault rates, chaos
    tables and draw provider, ``sim.draws``); ``key`` is the generator its
    ``init_nodes`` draws the initial weights from (``set_seed(cfg.seed)``,
    as ``run_experiment`` seeds a solo run)."""

    request: RunRequest
    handle: RunHandle
    sim: Any                 # GossipSimulator (or a variant)
    key: torch.Generator     # the init generator (set_seed(cfg.seed))
    signature: ShapeSignature

    @property
    def tenant(self) -> str:
        return self.request.tenant


def _topology_digest(topology: Any) -> str:
    """Content hash of the topology's edges (the int8 dense adjacency, or
    the CSR degrees and indices as int64): the JAX packer's bytes, so the
    same graph gives the same string in both packages."""
    try:
        adj = topology.adjacency
    except AttributeError:  # SparseTopology keeps no dense adjacency
        adj = None
    if adj is not None:
        payload = np.ascontiguousarray(np.asarray(adj, dtype=np.int8))
    else:
        payload = np.concatenate([
            np.asarray(topology.degrees, dtype=np.int64).ravel(),
            np.asarray(topology.indices, dtype=np.int64).ravel()])
    return f"{zlib.crc32(payload.tobytes()):08x}"


def _dtype_name(v) -> str:
    """A tensor's or an array's dtype as numpy spells it."""
    if isinstance(v, torch.Tensor):
        return str(v.dtype).replace("torch.", "")
    return str(np.asarray(v).dtype)


def _data_shapes(data: dict) -> dict:
    """The stacked data's geometry (``sim.data`` holds tensors)."""
    return {k: [list(v.shape), _dtype_name(v)]
            for k, v in sorted(data.items())}


def _chaos_shape(sim: Any) -> Optional[dict]:
    """The chaos facts a bucket shares: the schedule's array shapes, the
    component count and the edge-mask form (``"dense"``, ``"slot"``, or
    None without edge faults). None for a chaos-free simulator."""
    if getattr(sim, "chaos", None) is None:
        return None
    from ..simulation.faults import schedule_shape_summary
    edge_form = None
    if sim._chaos_edges:
        edge_form = "slot" if sim._sparse else "dense"
    return {
        "schedule": schedule_shape_summary(sim.chaos_schedule),
        "n_components": sim._chaos_ncomp,
        "edge_form": edge_form,
    }


def shape_signature(request: RunRequest, sim: Any) -> ShapeSignature:
    """The bucket key of a built run (see the module doc for what it
    covers). Facts of the built simulator come on top of the config's
    ``shape_fields()`` because several are derived at construction
    (mailbox slots from the topology's fan-in, metric names from the
    handler) and a config-only key could lie."""
    fields = {
        "config": request.config.shape_fields(),
        "simulator_class": type(sim).__name__,
        "n_nodes": sim.n_nodes,
        "mailbox_slots": sim.K,
        "reply_slots": sim.Kr,
        "max_fires_per_round": sim.F,
        "history_dtype": sim.history_dtype,
        "fused_merge": sim.fused_merge,
        "delay": repr(sim.delay),
        "probes": sim.probes.to_dict() if sim.probes is not None else None,
        "sentinels": (sim.sentinels.to_dict()
                      if sim.sentinels is not None else None),
        "topology": _topology_digest(sim.topology),
        "data_shapes": _data_shapes(sim.data),
        # The spec refuses cohort requests; the signature still covers
        # the cohort geometry, as the JAX packer's does.
        "cohort": (sim.cohort.to_dict()
                   if getattr(sim, "cohort", None) is not None else None),
        "chaos_shape": _chaos_shape(sim),
    }
    digest = hashlib.sha1(
        json.dumps(fields, sort_keys=True, default=str).encode()
    ).hexdigest()[:12]
    return ShapeSignature(digest=digest, summary=fields)


def build_request(request: RunRequest, handle: Optional[RunHandle] = None,
                  sentinels_default: bool = True,
                  device=None) -> BuiltRun:
    """Build a request into a :class:`BuiltRun` on ``device`` (``cuda``
    unless ``"cpu"`` is given): seed the host RNGs as ``run_experiment``
    does (``set_seed(cfg.seed)`` for the init, the simulator's own
    ``TorchDraws(cfg.seed)`` for the rounds), so a served tenant runs the
    trajectory of its solo run; build the simulator and its data; compute
    the signature.

    ``sentinels_default=True`` turns the sentinels on unless the config
    says otherwise: eviction on a trip (the service's failure isolation)
    needs the ``health_trip`` flag. It is done on a copy of the config
    and is part of the signature, so a tenant that configured the
    sentinels itself buckets apart.
    """
    from .. import set_seed
    from ..config import build_experiment

    cfg = request.config
    if sentinels_default and "sentinels" not in cfg.simulator_params:
        cfg = dataclasses.replace(
            cfg, simulator_params={**cfg.simulator_params,
                                   "sentinels": True})
        request = dataclasses.replace(request, config=cfg)
    key = set_seed(cfg.seed)
    sim, _ = build_experiment(cfg, request.data, device)
    if handle is None:
        handle = RunHandle(request=request)
    else:
        handle.request = request
    sig = shape_signature(request, sim)
    handle.bucket = sig.digest
    return BuiltRun(request=request, handle=handle, sim=sim, key=key,
                    signature=sig)


@dataclasses.dataclass
class Bucket:
    """Runs of one shape signature: the scheduler starts them together
    and advances them slice by slice."""

    signature: ShapeSignature
    runs: list

    @property
    def size(self) -> int:
        return len(self.runs)

    @property
    def tenants(self) -> list:
        return [r.tenant for r in self.runs]


def pack(built: list) -> list:
    """Group built runs into buckets by shape signature, in first-seen
    order (the scheduler takes the buckets in turn in this order). Equal
    signatures share a bucket; any difference (population, model,
    mailbox geometry, dtypes, probes/sentinels, topology content, data
    shapes) splits."""
    by_sig: dict[str, Bucket] = {}
    order: list[str] = []
    for run in built:
        d = run.signature.digest
        if d not in by_sig:
            by_sig[d] = Bucket(signature=run.signature, runs=[])
            order.append(d)
        by_sig[d].runs.append(run)
    return [by_sig[d] for d in order]
