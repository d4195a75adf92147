"""Simulation reporting: host-side view over the engine's per-round counters.

A numpy copy of ``gossipy_tpu/simulation/report.py``, kept equal to it so
reports from the two packages read and serialise alike
(``tests/test_torch_isolation.py`` holds the two against each other). The
port's engine fills only the fields its path produces; the registry keeps
the JAX package's full list so a saved report loads in either package.

The reference uses an Observer pattern (``SimulationEventReceiver`` /
``SimulationReport``, gossipy/simul.py:37-270) with per-message callbacks.
A jitted engine cannot call back per message, so the engine emits per-round
arrays (message counters, mean metrics) from the scan, and this module wraps
them in an API-compatible report: ``get_evaluation(local)`` returns the
``[(round, {metric: mean})]`` list the reference produces
(simul.py:262-266).

Telemetry extensions beyond the reference's report:

- ``failed_per_cause``: the per-round failure breakdown
  (:data:`~gossipy_tpu_torch.telemetry.FAILURE_CAUSES`: drop / offline /
  overflow) whose per-round sum equals ``failed_per_round`` bit-for-bit.
- ``mailbox_hwm_per_round`` / ``compact_slots_per_round`` /
  ``wide_slots_per_round``: mailbox occupancy high-water mark and the
  compact-vs-wide delivery-path indicator (engine runs only; None from
  engines without a mailbox).
- gossip-dynamics probe arrays (``probe_*``; present when the run was
  started with ``probes=``; probes are not ported yet):
  consensus distance (mean/max/per-layer), merge-staleness distribution
  (mean/max/histogram), per-node accepted-merge counts and the
  merge-delta vs train-delta norms.
- ``wall_clock_seconds_per_round`` / ``rounds_per_sec_ema``: host timing
  captured through the live io_callback path (None for non-live runs).
- ``to_dict()`` / ``save(path)`` / ``from_dict()`` / ``load(path)``: a
  JSON-able, round-trippable run record (strict JSON: NaN rows → nulls).

Optional per-round arrays are REGISTRY-driven (:data:`PER_ROUND_FIELDS` /
:data:`STATIC_FIELDS`): ``to_dict``, ``from_dict`` and ``concatenate`` all
iterate the registry, so a newly added per-round array can never be
silently dropped by one of them — adding a field is one registry line
(tests assert every array attribute survives the
save → load → concatenate round trip).
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

# 1: sent/failed/size/evals; 2: + cause breakdown & mailbox/compact diag;
# 3: + gossip-dynamics probe arrays (probe_*) and the static probe context;
# 4: + numerics-sentinel health arrays (health_*; telemetry.health);
# 5: + scheduled-fault chaos arrays (chaos_*; simulation.faults) and the
#    optional "chaos" key in failed_per_cause;
# 6: + performance arrays (perf_*; telemetry.cost) — host-measured
#    ms/round and the per-round MFU estimate;
# 7: + active-cohort accounting arrays (cohort_*; simulation.cohort) —
#    pool coverage fraction and the materialized cohort width per round.
REPORT_SCHEMA = 7

# Optional per-round arrays (attribute name == JSON key), concatenated
# along axis 0 by :meth:`SimulationReport.concatenate` (surviving only
# when EVERY segment carries them) and round-tripped by
# ``to_dict``/``from_dict``. int-valued entries round-trip as ints; float
# entries may carry NaN (serialized as null).
PER_ROUND_FIELDS = (
    "mailbox_hwm_per_round",
    "compact_slots_per_round",
    "wide_slots_per_round",
    "probe_consensus_mean",          # [R] f32
    "probe_consensus_max",           # [R] f32
    "probe_consensus_per_layer",     # [R, L] f32
    "probe_stale_mean",              # [R] f32
    "probe_stale_max",               # [R] i32
    "probe_stale_hist",              # [R, B] i32; rows sum to accepted count
    "probe_accepted_per_node",       # [R, N] i32
    "probe_merge_delta",             # [R] f32 (NaN when not decomposable)
    "probe_train_delta",             # [R] f32
    "health_nonfinite_params",       # [R, L] i32: non-finite count per leaf
    "health_nonfinite_delta",        # [R, L] i32: ... on the round delta
    "health_nonfinite_metrics",      # [R] i32: ... in evaluated metric rows
    "health_first_bad_slot",         # [R] i32: first deliver slot whose
                                     # merge introduced a non-finite; -1 clean
    "health_mix_nonfinite",          # [R] i32 (All2All): non-finite mixing
                                     # weights this round
    "health_diverged_per_node",      # [R, N] i32: norm-vs-EMA flags
    "health_param_norm_max",         # [R] f32
    "health_delta_norm",             # [R] f32: round movement L2
    "health_delta_hwm",              # [R] f32: running high-water mark
    "health_mailbox_hwm_run",        # [R] i32: run-level saturation watermark
    "health_trip",                   # [R] i32: any sentinel tripped
    "chaos_component_gap",           # [R] f32: max distance between
                                     # scheduled-component mean params
    "chaos_within_mean",             # [R] f32: mean distance of nodes from
                                     # their own component's mean
    "chaos_active_components",       # [R] i32: non-empty components
    "perf_round_ms",                 # [R] f64: host-measured wall ms per
                                     # round (uniform within one start()
                                     # segment; perf= runs only)
    "perf_mfu_est",                  # [R] f32: flops/round vs the chip
                                     # peak (NaN off known accelerators)
    "cohort_coverage",               # [R] f32: fraction of the nominal
                                     # pool touched by any cohort so far
                                     # (cohort runs only)
    "cohort_active_nodes",           # [R] i32: materialized cohort width
                                     # C (cohort runs only)
    "wall_clock_seconds_per_round",  # [R] f64 (live runs only)
)

# Static (non-per-round) optional fields: carried from the FIRST segment by
# ``concatenate`` and round-tripped verbatim by ``to_dict``/``from_dict``.
STATIC_FIELDS = (
    "probe_layer_names",      # [L] list[str]: consensus per-layer ordering
    "probe_expected_fanin",   # [N] f64: topology's expected accepted fan-in
    "health_layer_names",     # [L] list[str]: health per-leaf ordering
)

# Integer-valued per-round fields (restored as int arrays by from_dict).
_INT_FIELDS = frozenset({
    "mailbox_hwm_per_round", "compact_slots_per_round",
    "wide_slots_per_round", "probe_stale_max", "probe_stale_hist",
    "probe_accepted_per_node",
    "health_nonfinite_params", "health_nonfinite_delta",
    "health_nonfinite_metrics", "health_first_bad_slot",
    "health_mix_nonfinite", "health_diverged_per_node",
    "health_mailbox_hwm_run", "health_trip",
    "chaos_active_components", "cohort_active_nodes",
})


class SimulationReport:
    """Results of a simulation run.

    Parameters mirror what the engine's scan emits:

    - ``metric_names``: static ordering of the metric dict keys
    - ``local_evals`` / ``global_evals``: float arrays [R, M] of per-round
      mean metric values (NaN where no eval ran)
    - ``sent`` / ``failed``: int arrays [R] of messages generated / lost
      (drop, churn, mailbox overflow) per round
    - ``total_size``: cumulative message size in "atomic scalar" units, the
      reference's ``Sizeable`` accounting (gossipy/__init__.py:134-156)
    - ``failed_by_cause``: optional {cause: [R] int array} breakdown whose
      per-round sum equals ``failed``
    - ``mailbox_hwm`` / ``compact_slots`` / ``wide_slots``: optional [R]
      engine diagnostics (see the engine's ``_deliver_phase``)
    - ``**extras``: any field named in :data:`PER_ROUND_FIELDS` /
      :data:`STATIC_FIELDS` (the probe arrays land here); unknown names
      raise.
    """

    def __init__(self,
                 metric_names: list[str],
                 local_evals: Optional[np.ndarray],
                 global_evals: Optional[np.ndarray],
                 sent: np.ndarray,
                 failed: np.ndarray,
                 total_size: int,
                 failed_by_cause: Optional[dict] = None,
                 mailbox_hwm: Optional[np.ndarray] = None,
                 compact_slots: Optional[np.ndarray] = None,
                 wide_slots: Optional[np.ndarray] = None,
                 **extras):
        self.metric_names = list(metric_names)
        self._local = local_evals
        self._global = global_evals
        self.sent_messages = int(np.sum(sent))
        self.failed_messages = int(np.sum(failed))
        self.sent_per_round = np.asarray(sent)
        self.failed_per_round = np.asarray(failed)
        self.total_size = int(total_size)
        self.failed_per_cause: Optional[dict] = (
            {k: np.asarray(v) for k, v in failed_by_cause.items()}
            if failed_by_cause is not None else None)
        # Registry-driven optional fields: every name defaults to None,
        # then the legacy named params and **extras fill them in.
        for name in PER_ROUND_FIELDS + STATIC_FIELDS:
            setattr(self, name, None)
        legacy = {"mailbox_hwm_per_round": mailbox_hwm,
                  "compact_slots_per_round": compact_slots,
                  "wide_slots_per_round": wide_slots}
        for name, val in {**legacy, **extras}.items():
            if name not in PER_ROUND_FIELDS and name not in STATIC_FIELDS:
                raise TypeError(
                    f"unknown report field {name!r}; add it to "
                    "PER_ROUND_FIELDS/STATIC_FIELDS so to_dict/concatenate "
                    "cannot silently drop it")
            if val is None:
                continue
            if name in PER_ROUND_FIELDS:
                val = np.asarray(val)
            setattr(self, name, val)
        # Host wall-clock EMA (live io_callback runs only; attach_wall_clock).
        self.rounds_per_sec_ema: Optional[float] = None

    def attach_wall_clock(self, t_start: float, round_times: list,
                          ema_alpha: float = 0.1) -> None:
        """Derive per-round wall-clock and a rounds/sec EMA from the host
        timestamps the live io_callback collected (one per round boundary,
        measured from ``t_start`` = just before dispatch). The first
        interval includes compile time on a cold run — the EMA seeds from
        the SECOND round when there is one, so a cold compile does not
        poison the steady-state rate."""
        ts = np.asarray([t_start] + list(round_times), dtype=np.float64)
        per_round = np.diff(ts)
        if per_round.size == 0:
            return
        self.wall_clock_seconds_per_round = per_round
        rates = 1.0 / np.maximum(per_round, 1e-9)
        ema = rates[1] if rates.size > 1 else rates[0]
        for v in rates[2:]:
            ema = (1.0 - ema_alpha) * ema + ema_alpha * v
        self.rounds_per_sec_ema = float(ema)

    def _to_rounds(self, arr: Optional[np.ndarray]):
        if arr is None:
            return []
        out = []
        for r in range(arr.shape[0]):
            row = arr[r]
            if np.all(np.isnan(row)):
                continue
            out.append((r + 1, {k: float(v) for k, v in zip(self.metric_names, row)}))
        return out

    def get_evaluation(self, local: bool = True):
        """[(round, {metric: mean})] — API parity with reference simul.py:262-266."""
        return self._to_rounds(self._local if local else self._global)

    def curves(self, local: bool = True,
               drop_nan: bool = True) -> dict[str, np.ndarray]:
        """{metric: array} convenience view for plotting/benchmarks.

        ``drop_nan=True`` (default) removes rounds where no evaluation ran
        (``eval_every > 1`` skips), so ``curves(...)["accuracy"][-1]`` is
        always the LAST EVALUATED value; the matching round numbers are
        ``eval_rounds(local)``. Pass ``drop_nan=False`` for row-per-round
        arrays aligned with ``sent_per_round``.
        """
        arr = self._local if local else self._global
        if arr is None:
            return {}
        if drop_nan:
            keep = ~np.all(np.isnan(arr), axis=1)
            arr = arr[keep]
        return {k: arr[:, i] for i, k in enumerate(self.metric_names)}

    def eval_rounds(self, local: bool = True) -> np.ndarray:
        """1-based round numbers where evaluation ran (rows of ``curves``)."""
        arr = self._local if local else self._global
        if arr is None:
            return np.zeros((0,), dtype=int)
        return np.nonzero(~np.all(np.isnan(arr), axis=1))[0] + 1

    def final(self, metric: str, local: bool = False) -> float:
        """Last evaluated value of ``metric``; NaN when the metric was never
        evaluated OR is not one this run's handler produces (an unknown
        name is an empty series, not an exception — callers probe
        uniformly across handler types)."""
        arr = self._local if local else self._global
        if arr is None or metric not in self.metric_names:
            return float("nan")
        col = arr[:, self.metric_names.index(metric)]
        col = col[~np.isnan(col)]
        return float(col[-1]) if len(col) else float("nan")

    def to_dict(self) -> dict:
        """The full run record as JSON-able primitives (strict JSON: every
        NaN — skipped-eval metric rows, non-decomposable probe deltas —
        becomes null). Optional per-round/static fields are emitted from
        the module registry, so new fields cannot be forgotten here."""
        def scrub(x):
            if isinstance(x, list):
                return [scrub(v) for v in x]
            if isinstance(x, float) and np.isnan(x):
                return None
            return x

        def arr(a):
            return None if a is None else scrub(np.asarray(a).tolist())
        out = {
            "schema": REPORT_SCHEMA,
            "metric_names": self.metric_names,
            "sent_messages": self.sent_messages,
            "failed_messages": self.failed_messages,
            "total_size": self.total_size,
            "sent_per_round": arr(self.sent_per_round),
            "failed_per_round": arr(self.failed_per_round),
            "failed_per_cause": (
                {k: arr(v) for k, v in self.failed_per_cause.items()}
                if self.failed_per_cause is not None else None),
            "local_evals": arr(self._local),
            "global_evals": arr(self._global),
            "rounds_per_sec_ema": self.rounds_per_sec_ema,
        }
        for name in PER_ROUND_FIELDS:
            out[name] = arr(getattr(self, name))
        for name in STATIC_FIELDS:
            val = getattr(self, name)
            out[name] = (arr(val) if isinstance(val, np.ndarray)
                         else scrub(val) if isinstance(val, list) else val)
        return out

    def save(self, path: str) -> str:
        """Write :meth:`to_dict` as JSON to ``path``."""
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=2, allow_nan=False)
            fh.write("\n")
        return path

    @classmethod
    def from_dict(cls, d: dict) -> "SimulationReport":
        """Rebuild a report from :meth:`to_dict` output (any schema
        version; absent fields come back None, nulls inside float arrays
        come back NaN)."""
        def unscrub(x):
            if isinstance(x, list):
                return [unscrub(v) for v in x]
            return np.nan if x is None else x

        def farr(v):
            return None if v is None else np.asarray(unscrub(v), np.float64)

        def opt(name):
            v = d.get(name)
            if v is None:
                return None
            if name in _INT_FIELDS:
                return np.asarray(v, np.int64)
            return np.asarray(unscrub(v), np.float64)

        causes = d.get("failed_per_cause")
        extras = {name: opt(name) for name in PER_ROUND_FIELDS}
        for name in STATIC_FIELDS:
            v = d.get(name)
            if v is None:
                continue
            extras[name] = (np.asarray(v, np.float64)
                            if name == "probe_expected_fanin" else list(v))
        rep = cls(
            metric_names=list(d["metric_names"]),
            local_evals=farr(d.get("local_evals")),
            global_evals=farr(d.get("global_evals")),
            sent=np.asarray(d["sent_per_round"], np.int64),
            failed=np.asarray(d["failed_per_round"], np.int64),
            total_size=int(d["total_size"]),
            failed_by_cause=({k: np.asarray(v, np.int64)
                              for k, v in causes.items()}
                             if causes is not None else None),
            **{k: v for k, v in extras.items() if v is not None})
        if d.get("rounds_per_sec_ema") is not None:
            rep.rounds_per_sec_ema = float(d["rounds_per_sec_ema"])
        return rep

    @classmethod
    def load(cls, path: str) -> "SimulationReport":
        """Read a report written by :meth:`save`."""
        with open(path) as fh:
            return cls.from_dict(json.load(fh))

    @classmethod
    def concatenate(cls, reports: list) -> "SimulationReport":
        """Stitch consecutive run segments (e.g. the PENS phase split) into
        one report. Optional per-round arrays (module registry) survive
        only when EVERY segment carries them; static fields carry over
        from the first segment."""
        def cat(arrs):
            arrs = [a for a in arrs if a is not None]
            return np.concatenate(arrs) if arrs else None

        def cat_all(key):
            vals = [getattr(r, key, None) for r in reports]
            if any(v is None for v in vals):
                return None
            return np.concatenate(vals)

        causes = None
        if all(r.failed_per_cause is not None for r in reports):
            keys = reports[0].failed_per_cause.keys()
            causes = {k: np.concatenate([r.failed_per_cause[k]
                                         for r in reports]) for k in keys}
        extras = {name: cat_all(name) for name in PER_ROUND_FIELDS}
        for name in STATIC_FIELDS:
            extras[name] = getattr(reports[0], name, None)
        return cls(
            metric_names=reports[0].metric_names,
            local_evals=cat([r._local for r in reports]),
            global_evals=cat([r._global for r in reports]),
            sent=np.concatenate([r.sent_per_round for r in reports]),
            failed=np.concatenate([r.failed_per_round for r in reports]),
            total_size=sum(r.total_size for r in reports),
            failed_by_cause=causes,
            **{k: v for k, v in extras.items() if v is not None})

    def __str__(self) -> str:
        return json.dumps({
            "sent_messages": self.sent_messages,
            "failed_messages": self.failed_messages,
            "total_size": self.total_size,
            "rounds": 0 if self._local is None and self._global is None
                      else int((self._local if self._local is not None
                                else self._global).shape[0]),
            "metrics": self.metric_names,
        }, indent=2)
