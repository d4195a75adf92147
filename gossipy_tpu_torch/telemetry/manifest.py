"""Run manifest: the one JSON record that says what produced a curve.

Counterpart of ``gossipy_tpu/telemetry/manifest.py``, with the same schema
and keys. :class:`RunManifest` collects, on the host and without touching
the device:

- the simulator's configuration snapshot (population, protocol, fault
  rates, mailbox geometry, handler and topology classes, deliver path,
  the telemetry switches),
- software versions (torch, its CUDA, numpy) and the git revision,
- the backend: ``"cuda"`` or ``"cpu"`` (the simulator's device), the
  card's name and the device count from ``torch.cuda``,
- the engine's ``memory_budget()`` output.

The port compiles nothing, so ``compile_seconds`` and
``compilation_cache`` stay None. ``mesh`` is the simulator's mesh
(``axis_names`` and ``shape``, :mod:`gossipy_tpu_torch.parallel`), None
without one, and the config's ``partition_rules`` the rule table every
placement derives from (``parallel/rules.py``).
``perf`` is the simulator's ``perf_summary()`` when it runs with
``perf=``, and ``trace`` carries :func:`.tracing.trace_report`'s totals
when it records a trace.
"""

from __future__ import annotations

import json
import subprocess
import time
from dataclasses import dataclass, field
from typing import Any, Optional

MANIFEST_SCHEMA = 1


def _versions() -> dict:
    out = {}
    for mod in ("torch", "numpy"):
        try:
            out[mod] = __import__(mod).__version__
        except Exception:
            out[mod] = None
    try:
        import torch
        out["cuda"] = torch.version.cuda
    except Exception:
        out["cuda"] = None
    return out


def git_revision(cwd: Optional[str] = None) -> Optional[str]:
    """Short git HEAD of the checkout containing this package (or of
    ``cwd`` when given), or None outside a repo or without git."""
    if cwd is None:
        import os
        cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        proc = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                              capture_output=True, text=True, timeout=10,
                              cwd=cwd)
    except (OSError, subprocess.TimeoutExpired):
        return None
    rev = proc.stdout.strip()
    return rev if proc.returncode == 0 and rev else None


def git_dirty(cwd: Optional[str] = None) -> Optional[bool]:
    """Whether the checkout containing this package (or ``cwd``) has
    uncommitted changes; None outside a repo or without git."""
    if cwd is None:
        import os
        cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        proc = subprocess.run(["git", "status", "--porcelain"],
                              capture_output=True, text=True, timeout=10,
                              cwd=cwd)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0:
        return None
    return bool(proc.stdout.strip())


def code_version_block() -> Optional[dict]:
    """``{"git_sha", "dirty"}`` or None outside a checkout: the
    provenance block manifests and flight-recorder bundles carry."""
    sha = git_revision()
    if sha is None:
        return None
    return {"git_sha": sha, "dirty": git_dirty()}


def _backend_info(device=None) -> dict:
    """The backend of ``device`` (default: the card when there is one):
    ``"cuda"`` with the card's name and the device count, or ``"cpu"``."""
    try:
        import torch
        dev = torch.device(device if device is not None else
                           ("cuda" if torch.cuda.is_available() else "cpu"))
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        return {"backend": dev.type, "device_kind": kind,
                "device_count": count if dev.type == "cuda" else 1,
                "process_count": 1}
    except Exception as e:  # a backend failure must not kill the record
        return {"backend": None, "error": repr(e)[:200]}


def _config_snapshot(sim: Any) -> dict:
    """Config dict from a simulator's public attributes, read with
    ``getattr`` so every engine (the variants, the sequential engine)
    gives one; absent knobs are omitted. The JAX package's keys."""
    snap: dict = {"simulator": type(sim).__name__}
    handler = getattr(sim, "handler", None)
    if handler is not None:
        snap["handler"] = type(handler).__name__
        mode = getattr(handler, "mode", None)
        if mode is not None:
            snap["create_model_mode"] = getattr(mode, "name", str(mode))
    topo = getattr(sim, "topology", None)
    if topo is not None:
        snap["topology"] = type(topo).__name__
    for attr, key in (("n_nodes", "n_nodes"), ("delta", "delta"),
                      ("drop_prob", "drop_prob"),
                      ("online_prob", "online_prob"),
                      ("sampling_eval", "sampling_eval"),
                      ("eval_every", "eval_every"), ("sync", "sync"),
                      ("K", "mailbox_slots"), ("Kr", "reply_slots"),
                      ("F", "max_fires_per_round"),
                      ("fused_merge", "fused_merge"),
                      ("history_dtype", "history_dtype"),
                      ("_compact_cap", "compact_cap")):
        if hasattr(sim, attr):
            snap[key] = getattr(sim, attr)
    proto = getattr(sim, "protocol", None)
    if proto is not None:
        snap["protocol"] = getattr(proto, "name", str(proto))
    delay = getattr(sim, "delay", None)
    if delay is not None:
        snap["delay"] = repr(delay)
    for attr in ("probes", "sentinels", "chaos", "perf"):
        if hasattr(sim, attr):
            cfg = getattr(sim, attr)
            snap[attr] = cfg.to_dict() if cfg is not None else None
    if hasattr(sim, "cohort"):
        # The active CohortConfig (simulation.cohort) or None; a cohort
        # run also records the nominal population (``n_nodes`` is the
        # cohort width C there) and the nominal topology's class the
        # C-node round world replaced.
        cohort = sim.cohort
        snap["cohort"] = cohort.to_dict() if cohort is not None else None
        if cohort is not None:
            snap["nominal_n"] = getattr(sim, "nominal_n", None)
            nom = getattr(sim, "nominal_topology", None)
            if nom is not None:
                snap["topology"] = type(nom).__name__
    if hasattr(sim, "topology"):
        # The partition-rule table (parallel/rules.py) every placement of
        # a run on a mesh derives from.
        from ..parallel.rules import STATE_RULES, rules_table
        snap["partition_rules"] = rules_table(STATE_RULES)
    if hasattr(sim, "metrics_enabled"):
        # Whether this run fed the process metrics registry.
        snap["metrics"] = bool(sim.metrics_enabled)
    if hasattr(sim, "tracer"):
        snap["tracing"] = sim.tracer is not None
    if hasattr(sim, "ledger"):
        # Whether this run appended digest rows to a run ledger (left out
        # of the ledger's own config fingerprint).
        snap["ledger"] = sim.ledger is not None
    return snap


def _mesh_info(sim: Any) -> Optional[dict]:
    """The simulator's mesh as its axis names and sizes (None without
    one)."""
    mesh = getattr(sim, "mesh", None)
    if mesh is None:
        return None
    return {"axis_names": list(mesh.axis_names),
            "shape": {str(k): int(v) for k, v in dict(mesh.shape).items()}}


@dataclass
class RunManifest:
    """Run record; build with :meth:`from_simulator`."""

    config: dict
    backend: dict
    versions: dict
    git_rev: Optional[str] = None
    code_version: Optional[dict] = None
    memory_budget: Optional[dict] = None
    mesh: Optional[dict] = None
    compile_seconds: Optional[float] = None
    compilation_cache: Optional[dict] = None
    telemetry_sink: Optional[dict] = None
    perf: Optional[dict] = None
    trace: Optional[dict] = None
    created_at: float = field(default_factory=time.time)
    extra: dict = field(default_factory=dict)
    schema: int = MANIFEST_SCHEMA

    @classmethod
    def from_simulator(cls, sim: Any,
                       extra: Optional[dict] = None,
                       config_overrides: Optional[dict] = None
                       ) -> "RunManifest":
        """Collect the manifest for ``sim``. ``config_overrides`` patches
        entries of the config snapshot after collection (the service
        stamps each tenant's seed and name into its manifest)."""
        budget = None
        if hasattr(sim, "memory_budget"):
            try:
                budget = sim.memory_budget()
            except Exception:
                budget = None
        try:
            from .sink import get_sink
            sink = get_sink()
            sink_stats = {"events_in_ring": len(sink.events()),
                          "dropped_events": sink.dropped_events,
                          "maxlen": sink.maxlen}
        except Exception:
            sink_stats = None
        perf = None
        if getattr(sim, "perf", None) is not None:
            # The performance block: the analytic estimate, the last
            # run's timing and MFU, the banked peaks; best-effort.
            try:
                perf = sim.perf_summary()
            except Exception:
                perf = None
        trace = None
        if getattr(sim, "tracer", None) is not None:
            try:
                from .tracing import trace_report
                trace = trace_report(sim.tracer.snapshot())["totals"]
            except Exception:
                trace = None
        config = _config_snapshot(sim)
        if config_overrides:
            config.update(config_overrides)
        return cls(
            config=config,
            backend=_backend_info(getattr(sim, "device", None)),
            versions=_versions(),
            git_rev=git_revision(),
            code_version=code_version_block(),
            memory_budget=budget,
            mesh=_mesh_info(sim),
            compile_seconds=None,
            compilation_cache=None,
            telemetry_sink=sink_stats,
            perf=perf,
            trace=trace,
            extra=dict(extra or {}),
        )

    def to_dict(self) -> dict:
        out = {
            "schema": self.schema,
            "created_at": self.created_at,
            "config": self.config,
            "backend": self.backend,
            "versions": self.versions,
            "git_rev": self.git_rev,
            "code_version": self.code_version,
            "memory_budget": self.memory_budget,
            "mesh": self.mesh,
            "compile_seconds": self.compile_seconds,
            "compilation_cache": self.compilation_cache,
            "telemetry_sink": self.telemetry_sink,
            "perf": self.perf,
            "trace": self.trace,
        }
        if self.extra:
            out["extra"] = self.extra
        return _jsonable(out)

    def to_json(self, **kwargs) -> str:
        return json.dumps(self.to_dict(), **kwargs)

    def save(self, path: str) -> str:
        with open(path, "w") as fh:
            fh.write(self.to_json(indent=2) + "\n")
        return path


def _jsonable(obj):
    """Coerce numpy scalars and arrays (and 0-d or small tensors) so
    ``json.dumps`` never chokes on a config value; unknown objects fall
    back to ``repr``."""
    import numpy as np
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if type(obj).__name__ == "Tensor":
        return _jsonable(obj.detach().cpu().numpy())
    return repr(obj)[:200]
