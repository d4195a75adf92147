"""Numerics sentinels: per-round numerical-health vitals.

Counterpart of the sentinels of ``gossipy_tpu/telemetry/health.py``
(``GossipSimulator(sentinels=True | SentinelConfig)``), over the port's
flat ``[N, stride]`` parameter rows. Every count and norm reads the leaf
columns only (the spans of :mod:`gossipy_tpu_torch.telemetry.probes`),
never the row's padding, and never the history ring:

- non-finite counts on the params and on the round's param delta, per
  leaf, plus non-finite entries in the round's evaluated metric rows;
- per-node divergence flags (a node whose param L2 norm exceeds a
  multiple of its own EMA) and the population-max norm;
- the round-delta norm with its running high-water mark, and the
  run-level mailbox-saturation watermark;
- a per-round ``health_trip`` flag: a non-finite count or a divergence
  flag fired this round.

On a mesh across ranks the engine computes the vitals over the whole
population on every rank (the round-start and round-end rows gathered,
the round's mailbox high-water mark the largest of the ranks'), so
``health_trip`` and every count are the same on every rank.

And the flight recorder (:class:`FlightRecorder`): it drives a run in
chunks and, when a sentinel trips, the run raises, or the watchdog fires,
writes a repro bundle (the last healthy state and its draw state through
:mod:`gossipy_tpu_torch.checkpoint`, the run manifest, the trailing
telemetry events, the verdict). :func:`replay_bundle` restores a bundle
into a fresh simulator and replays it round by round, naming the first
divergent round, parameter leaf and node set, and re-runs the offending
round phase by phase (:func:`localize_first_nonfinite`) to name the
engine phase that made the first non-finite value.

Bundle directory schema (``BUNDLE_VERSION`` 1), the JAX package's files::

    <bundle>/
      checkpoint            the last HEALTHY state and the draw state at
                            its round (``torch.save``; see checkpoint.py)
      checkpoint.meta.json  {"bundle_version", "kind", "round"}
      manifest.json         the simulator's RunManifest
                            (extra.flight_recorder carries the bundle block)
      verdict.json          {"bundle_version", "kind": "sentinel" |
                             "exception" | "watchdog", "chunk_start_round",
                             "first_bad_round" | null, "detail": {...},
                             "perf": {last_round_ms, hbm_peak_bytes,
                                      flops_per_round_xla (null),
                                      compile_count (0), mfu_est}
                                     | null (perf= runs only)}
      events.jsonl          trailing telemetry events from the sink ring
                            (the per-round rows the recorder mirrors in),
                            oldest first

When ``GOSSIPY_TPU_LEDGER`` names a run ledger, each bundle is appended
to it as one failure row (:func:`~gossipy_tpu_torch.telemetry.ledger.
ingest_bundle`), as in the JAX recorder.

**On a mesh across ranks** every rank runs :meth:`FlightRecorder.run`
with its rows, and the design keeps every bundle free of collectives:

- The copy of a chunk's start state is the whole population's: one
  all-gather of its node-axis leaves before each chunk, on every rank
  (:func:`~gossipy_tpu_torch.parallel.gather_state`; its count and
  seconds are :attr:`FlightRecorder.gathers` and
  :attr:`FlightRecorder.gather_seconds`). Any bundle is then written
  from the host alone, never inside a collective.
- A sentinel trip is seen by every rank at the same round (each rank's
  report holds the whole population's vitals), so every rank leaves the
  chunk loop at the same chunk: rank 0 writes the ONE bundle (its
  checkpoint is the file one process writes), and every rank waits on a
  barrier before it returns the bundle's path.
- An exception out of ``start`` or the watchdog (a timer thread, while
  the main thread may wait in a collective) happens on one rank: that
  rank writes a bundle of its own, ``..._rank<r>``, and an exception is
  re-raised. Its peers, waiting in the round's next collective, fail
  when the rank's process leaves the group or at the group's timeout,
  each writing its own exception bundle in turn: no rank hangs.
"""

from __future__ import annotations

import json
import os
import threading
import warnings
from dataclasses import dataclass
from typing import Any, Optional, Union

import numpy as np
import torch

from .probes import Spans, leaf_columns, param_layer_names

BUNDLE_VERSION = 1


@dataclass(frozen=True)
class SentinelConfig:
    """Which numerical-health sentinels a simulator computes per round.

    - ``nonfinite``: per-leaf non-finite counts on params / round delta /
      evaluated metrics, and the first mailbox slot whose delivery
      introduced a non-finite value.
    - ``divergence``: per-node param-norm-vs-own-EMA divergence flags.
    - ``saturation``: run-level mailbox occupancy watermark.
    - ``ema_alpha``: EMA coefficient for the per-node norm tracker.
    - ``divergence_factor``: a node trips when its param norm exceeds
      ``divergence_factor * max(ema, norm_floor)``.
    - ``norm_floor``: keeps near-zero EMAs (fresh zero-init models) from
      tripping on the first real update.
    """

    nonfinite: bool = True
    divergence: bool = True
    saturation: bool = True
    ema_alpha: float = 0.1
    divergence_factor: float = 10.0
    norm_floor: float = 1e-6

    def __post_init__(self):
        if not 0.0 < self.ema_alpha <= 1.0:
            raise ValueError("ema_alpha must be in (0, 1]")
        if self.divergence_factor <= 1.0:
            raise ValueError("divergence_factor must be > 1 (a node is "
                             "flagged when its norm EXCEEDS the EMA by "
                             "this factor)")

    @classmethod
    def coerce(cls, sentinels: Union[None, bool, "SentinelConfig"]
               ) -> Optional["SentinelConfig"]:
        """Normalize the ``sentinels=`` constructor argument:
        ``None``/``False`` → off (None), ``True`` → all sentinels at
        defaults, a :class:`SentinelConfig` → itself (None when every
        sentinel is off)."""
        if sentinels is None or sentinels is False:
            return None
        if sentinels is True:
            return cls()
        if isinstance(sentinels, cls):
            if not (sentinels.nonfinite or sentinels.divergence
                    or sentinels.saturation):
                return None
            return sentinels
        raise TypeError("sentinels= expects None, bool or SentinelConfig; "
                        f"got {type(sentinels).__name__}")

    def to_dict(self) -> dict:
        return {"nonfinite": self.nonfinite, "divergence": self.divergence,
                "saturation": self.saturation, "ema_alpha": self.ema_alpha,
                "divergence_factor": self.divergence_factor,
                "norm_floor": self.norm_floor}


class HealthCarry:
    """Cross-round sentinel state: the per-node norm EMA (``[N]``
    float32), the rounds folded into it (a host int), the high-water mark
    of the round-delta norm (float32) and the run-level mailbox watermark
    (int32). It survives from round to round and across ``start()``
    calls; ``init_nodes`` starts a fresh one."""

    __slots__ = ("norm_ema", "rounds_seen", "delta_hwm", "mailbox_hwm_run")

    def __init__(self, norm_ema, rounds_seen, delta_hwm, mailbox_hwm_run):
        self.norm_ema = norm_ema
        self.rounds_seen = rounds_seen
        self.delta_hwm = delta_hwm
        self.mailbox_hwm_run = mailbox_hwm_run

    @staticmethod
    def zeros(n: int, device) -> "HealthCarry":
        return HealthCarry(
            torch.zeros(n, dtype=torch.float32, device=device), 0,
            torch.zeros((), dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def nonfinite_counts(params: torch.Tensor, spans: Spans) -> torch.Tensor:
    """``[L]`` int32: non-finite scalar count per leaf of the rows."""
    return torch.stack([(~torch.isfinite(x)).sum(dtype=torch.int32)
                        for x in leaf_columns(params, spans)])


def nonfinite_total(params: torch.Tensor, spans: Spans) -> torch.Tensor:
    """0-d int32: total non-finite count over every leaf of the rows."""
    return nonfinite_counts(params, spans).sum(dtype=torch.int32)


def per_node_param_norm(params: torch.Tensor, spans: Spans) -> torch.Tensor:
    """``[N]`` float32: each node's param L2 norm over its leaves."""
    total = torch.zeros(params.shape[0], dtype=torch.float32,
                        device=params.device)
    for x in leaf_columns(params, spans):
        total = total + (x * x).sum(dim=1)
    return torch.sqrt(total)


# Per-round health stat keys the engine emits (and the report/event layers
# consume), in the JAX package's order. ``health_first_bad_slot`` comes
# from the mailbox slot loop; ``health_mix_nonfinite`` from All2All only.
HEALTH_STAT_KEYS = (
    "health_nonfinite_params",
    "health_nonfinite_delta",
    "health_nonfinite_metrics",
    "health_first_bad_slot",
    "health_mix_nonfinite",
    "health_diverged_per_node",
    "health_param_norm_max",
    "health_delta_norm",
    "health_delta_hwm",
    "health_mailbox_hwm_run",
    "health_trip",
)


def health_round_stats(cfg: SentinelConfig, hc: HealthCarry,
                       pre_params: torch.Tensor, params: torch.Tensor,
                       local_metrics: Optional[torch.Tensor],
                       global_metrics: Optional[torch.Tensor],
                       spans: Spans,
                       mailbox_hwm: Optional[torch.Tensor] = None,
                       ) -> tuple[HealthCarry, dict]:
    """One round's sentinel vitals.

    ``pre_params``/``params`` are the round-start (a copy taken before the
    round) and round-end rows; ``local_metrics``/``global_metrics`` the
    round's metric vectors (an all-NaN row means evaluation was skipped
    this round, ``eval_every``, and counts zero). Returns the advanced
    carry and the round's ``health_*`` stats entries.
    """
    out: dict = {}
    dev = params.device
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    nf_any = torch.zeros((), dtype=torch.bool, device=dev)
    div_any = nf_any
    delta = params.to(torch.float32) - pre_params.to(torch.float32)
    if cfg.nonfinite:
        nf_p = nonfinite_counts(params, spans)
        nf_d = nonfinite_counts(delta, spans)
        out["health_nonfinite_params"] = nf_p
        out["health_nonfinite_delta"] = nf_d
        m = zero_i
        for v in (local_metrics, global_metrics):
            if v is None:
                continue
            ran = ~torch.isnan(v).all()
            m = m + torch.where(ran, (~torch.isfinite(v)).sum(
                dtype=torch.int32), zero_i)
        out["health_nonfinite_metrics"] = m
        nf_any = (nf_p.sum() + nf_d.sum() + m) > 0

    norms = per_node_param_norm(params, spans)
    if cfg.divergence:
        seeded = hc.rounds_seen > 0
        # rounds_seen is a host int: no sync.
        ema = hc.norm_ema if seeded else norms  # tracelint: disable=host-sync
        threshold = cfg.divergence_factor * ema.clamp(min=cfg.norm_floor)
        flags = ((norms > threshold) & seeded).to(torch.int32)
        # Non-finite norms stay out of the EMA (one NaN round must not
        # poison the baseline the healthy rounds are judged against).
        new_ema = torch.where(
            torch.isfinite(norms),
            (1.0 - cfg.ema_alpha) * ema + cfg.ema_alpha * norms, ema)
        hc = HealthCarry(new_ema, hc.rounds_seen, hc.delta_hwm,
                         hc.mailbox_hwm_run)
        out["health_diverged_per_node"] = flags
        out["health_param_norm_max"] = norms.max()
        div_any = flags.sum() > 0

    delta_sq = torch.zeros((), dtype=torch.float32, device=dev)
    for d in leaf_columns(delta, spans):
        delta_sq = delta_sq + (d * d).sum()
    delta_norm = torch.sqrt(delta_sq)
    new_hwm = torch.where(torch.isfinite(delta_norm),
                          torch.maximum(hc.delta_hwm, delta_norm),
                          hc.delta_hwm)
    out["health_delta_norm"] = delta_norm
    out["health_delta_hwm"] = new_hwm
    hc = HealthCarry(hc.norm_ema, hc.rounds_seen + 1, new_hwm,
                     hc.mailbox_hwm_run)

    if cfg.saturation and mailbox_hwm is not None:
        run_hwm = torch.maximum(hc.mailbox_hwm_run,
                                torch.as_tensor(mailbox_hwm, device=dev)
                                .to(torch.int32))
        hc = HealthCarry(hc.norm_ema, hc.rounds_seen, hc.delta_hwm, run_hwm)
        out["health_mailbox_hwm_run"] = run_hwm

    out["health_trip"] = (nf_any | div_any).to(torch.int32)
    return hc, out


def health_event_row(vals: dict) -> Optional[dict]:
    """The per-round ``update_health`` observer payload (JSON-able
    scalars) from one round's health values — keys for disabled
    sentinels are simply absent. Returns None when ``vals`` carries no
    health stat at all."""
    if not vals:
        return None
    row: dict = {}
    if "health_nonfinite_params" in vals:
        row["nonfinite_params"] = int(
            np.asarray(vals["health_nonfinite_params"]).sum())
        row["nonfinite_delta"] = int(
            np.asarray(vals["health_nonfinite_delta"]).sum())
        row["nonfinite_metrics"] = int(vals["health_nonfinite_metrics"])
    if "health_first_bad_slot" in vals:
        row["first_bad_slot"] = int(vals["health_first_bad_slot"])
    if "health_mix_nonfinite" in vals:
        row["mix_nonfinite"] = int(vals["health_mix_nonfinite"])
    if "health_diverged_per_node" in vals:
        row["diverged"] = int(
            np.asarray(vals["health_diverged_per_node"]).sum())
        row["param_norm_max"] = float(vals["health_param_norm_max"])
    if "health_delta_norm" in vals:
        row["delta_norm"] = float(vals["health_delta_norm"])
        row["delta_hwm"] = float(vals["health_delta_hwm"])
    if "health_mailbox_hwm_run" in vals:
        row["mailbox_hwm_run"] = int(vals["health_mailbox_hwm_run"])
    if "health_trip" in vals:
        row["trip"] = bool(int(vals["health_trip"]))
    return row or None


# -- flight recorder --------------------------------------------------------


def _first_trip_index(report) -> Optional[int]:
    """0-based index of the first tripped round in a report's
    ``health_trip`` array, or None."""
    trips = getattr(report, "health_trip", None)
    if trips is None:
        return None
    idx = np.nonzero(np.asarray(trips) > 0)[0]
    return int(idx[0]) if idx.size else None


def _sim_spans(sim):
    layout = sim.handler.layout
    return [(layout.offsets[name], int(np.prod(shape)))
            for name, shape in layout.leaves]


class FlightRecorder:
    """Chunked runner that captures a repro bundle on anomaly.

    Drives ``sim.start`` in ``chunk``-round segments, keeping a copy of
    each segment's start state and draw state as the last healthy
    checkpoint (``start`` updates its state in place, so the copy is what
    survives a tripped chunk). On the first tripped sentinel round, an
    exception out of ``start``, or the per-chunk watchdog deadline, the
    bundle is written (see the module doc for its files) and recording
    stops. The recorder mirrors each round's event row into the process
    telemetry sink (kind ``"round"``), so the bundle's ``events.jsonl``
    carries the trailing per-round history; when the sink ring's eviction
    truncated that window, a warning says so once.

    Usage::

        rec = FlightRecorder(out_dir, chunk=50)
        state, reports, bundle = rec.run(sim, state, n_rounds=1000)
        if bundle is not None:
            ...  # replay_bundle(bundle, fresh_sim) localizes the fault
    """

    def __init__(self, out_dir: str, chunk: int = 50,
                 trailing_rounds: int = 64,
                 watchdog_seconds: Optional[float] = None):
        self.out_dir = os.path.abspath(out_dir)
        self.chunk = int(chunk)
        assert self.chunk >= 1
        self.trailing_rounds = int(trailing_rounds)
        self.watchdog_seconds = watchdog_seconds
        self.bundle_path: Optional[str] = None
        self._rounds_recorded = 0
        self._warned_truncated = False
        # On a mesh across ranks: the start-state gathers, and their time.
        self.gathers = 0
        self.gather_seconds = 0.0

    # -- bundle writing ----------------------------------------------------

    def _bundle_dir(self, kind: str, chunk_start_round: int,
                    rank: Optional[int] = None) -> str:
        name = f"bundle_r{chunk_start_round:06d}_{kind}"
        if rank is not None:
            name += f"_rank{rank}"
        return os.path.join(self.out_dir, name)

    def _write_bundle(self, sim, state, draws, kind: str,
                      chunk_start_round: int,
                      first_bad_round: Optional[int] = None,
                      detail: Optional[dict] = None,
                      rank: Optional[int] = None) -> str:
        """Write the repro bundle for ``state`` (the last HEALTHY state, at
        round ``chunk_start_round``, with ``draws`` the draw state taken
        then; on a mesh across ranks the whole population's). ``rank``
        names a bundle one rank writes alone. Returns the bundle path."""
        from ..checkpoint import save_checkpoint
        from .sink import get_sink
        from .tracing import span

        path = self._bundle_dir(kind, chunk_start_round, rank)
        with span("flight_recorder.write_bundle", cat="checkpoint",
                  kind=kind, round=int(chunk_start_round)):
            os.makedirs(path, exist_ok=True)
            save_checkpoint(os.path.join(path, "checkpoint"), state,
                            draws=draws,
                            meta={"bundle_version": BUNDLE_VERSION,
                                  "kind": kind,
                                  "round": int(chunk_start_round)})

            detail = dict(detail or {})
            chaos_cfg = getattr(sim, "chaos", None)
            if chaos_cfg is not None and "chaos_windows" not in detail:
                # The fault windows active at the tripped round and at the
                # checkpoint round (a heal-induced trip fires just after
                # its window closes).
                at = (first_bad_round if first_bad_round is not None
                      else chunk_start_round)
                try:
                    detail["chaos_windows"] = chaos_cfg.active_at(at)
                    detail["chaos_windows_at_checkpoint"] = \
                        chaos_cfg.active_at(chunk_start_round)
                    detail["chaos_horizon"] = int(chaos_cfg.horizon)
                except Exception:  # verdict context is best-effort
                    pass
            verdict = {
                "bundle_version": BUNDLE_VERSION,
                "kind": kind,
                "chunk_start_round": int(chunk_start_round),
                "first_bad_round": (int(first_bad_round)
                                    if first_bad_round is not None else None),
                "detail": detail,
                # The performance context of a perf= run (its last
                # round's ms, MFU and peak allocation); None without.
                "perf": _verdict_perf(sim),
            }
            with open(os.path.join(path, "verdict.json"), "w") as fh:
                json.dump(verdict, fh, indent=2)
                fh.write("\n")

            try:
                sim.run_manifest(extra={"flight_recorder": {
                    "bundle_version": BUNDLE_VERSION, "kind": kind,
                    "chunk_start_round": int(chunk_start_round),
                    "trailing_rounds": self.trailing_rounds,
                }}).save(os.path.join(path, "manifest.json"))
            except Exception as e:  # manifest is context, not the evidence
                warnings.warn("flight recorder could not collect the run "
                              f"manifest: {e!r}")

            sink = get_sink()
            events = sink.events()
            round_events = [e for e in events if e.kind == "round"]
            want = min(self.trailing_rounds, self._rounds_recorded)
            if len(round_events) < want and sink.dropped_events > 0 \
                    and not self._warned_truncated:
                self._warned_truncated = True
                warnings.warn(
                    "flight recorder trailing window truncated: the "
                    "telemetry "
                    f"sink ring evicted {sink.dropped_events} events "
                    f"(maxlen {sink.maxlen}); the bundle carries "
                    f"{len(round_events)} of the requested {want} trailing "
                    "rounds. Install a larger TelemetrySink to keep more.")
            with open(os.path.join(path, "events.jsonl"), "w") as fh:
                for ev in events[-max(self.trailing_rounds, 1) * 2:]:
                    fh.write(json.dumps(ev.to_dict()) + "\n")

        self.bundle_path = path
        # A bundle is a run-ledger row (the verdict inline, the bundle
        # and its verdict as hashed artifacts) when GOSSIPY_TPU_LEDGER
        # names a ledger; best-effort, like the manifest.
        try:
            from .ledger import ingest_bundle, resolve_ledger
            led = resolve_ledger(None)
            if led is not None:
                ingest_bundle(led, path)
        except Exception:
            pass
        return path

    def write_bundle(self, sim, state, draws, kind: str,
                     chunk_start_round: int,
                     first_bad_round: Optional[int] = None,
                     detail: Optional[dict] = None,
                     rounds_recorded: Optional[int] = None) -> str:
        """Bundle capture for chunk loops the recorder does not own: ``state``
        must be the last HEALTHY state at round ``chunk_start_round`` and
        ``draws`` its draw state (a provider, or
        :func:`gossipy_tpu_torch.checkpoint.draw_record` taken then).
        ``rounds_recorded`` tells the trailing-window check how many rounds
        the loop mirrored into the sink. Returns the bundle path."""
        if rounds_recorded is not None:
            self._rounds_recorded = int(rounds_recorded)
        return self._write_bundle(sim, state, draws, kind, chunk_start_round,
                                  first_bad_round=first_bad_round,
                                  detail=detail)

    # -- driving -----------------------------------------------------------

    def run(self, sim, state, n_rounds: int, draws=None
            ) -> tuple[Any, list, Optional[str]]:
        """Run ``n_rounds`` rounds in chunks; returns ``(state, reports,
        bundle_path)``, ``bundle_path`` None for a clean run. ``draws`` is
        the run's provider, installed as ``sim.draws`` when given. On an
        exception out of ``sim.start`` the bundle is written first, then
        the exception re-raised. On a mesh across ranks every rank calls
        it (the module doc says how the bundles are written there)."""
        assert getattr(sim, "sentinels", None) is not None, \
            "FlightRecorder needs a sentinel-enabled simulator " \
            "(GossipSimulator(sentinels=True))"
        import time

        from ..checkpoint import _ranks_mesh, clone_state, draw_record
        from ..parallel import gather_state, is_writer, rank_barrier
        from ..simulation.events import CallbackReceiver
        from .sink import emit_event

        if draws is not None:
            sim.draws = draws
        mesh = _ranks_mesh(sim)
        rank = None if mesh is None else torch.distributed.get_rank()
        tap = CallbackReceiver(
            lambda row: emit_event("round", row), live=False)
        sim.add_receiver(tap)
        reports: list = []
        bundle: Optional[str] = None
        try:
            done = 0
            while done < n_rounds:
                c = min(self.chunk, n_rounds - done)
                if mesh is None:
                    start_state = clone_state(state)
                else:
                    t0 = time.perf_counter()
                    start_state = gather_state(state, mesh)
                    self.gather_seconds += time.perf_counter() - t0
                    self.gathers += 1
                start_draws = draw_record(sim.draws)
                start_round = int(state.round)
                timer = None
                if self.watchdog_seconds is not None:
                    timer = threading.Timer(
                        self.watchdog_seconds, self._write_bundle,
                        args=(sim, start_state, start_draws, "watchdog",
                              start_round),
                        kwargs={"detail": {
                            "watchdog_seconds": self.watchdog_seconds},
                            "rank": rank})
                    timer.daemon = True
                    timer.start()
                try:
                    state, report = sim.start(state, n_rounds=c)
                    dev = getattr(sim, "device", None)
                    if dev is not None and dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                except Exception as e:
                    bundle = self._write_bundle(
                        sim, start_state, start_draws, "exception",
                        start_round, detail={"error": repr(e)[:500]},
                        rank=rank)
                    raise
                finally:
                    if timer is not None:
                        timer.cancel()
                self._rounds_recorded += c
                reports.append(report)
                idx = _first_trip_index(report)
                if idx is not None:
                    if is_writer(mesh):
                        bundle = self._write_bundle(
                            sim, start_state, start_draws, "sentinel",
                            start_round, first_bad_round=start_round + idx,
                            detail=_trip_detail(sim, report, idx))
                    else:
                        bundle = self.bundle_path = self._bundle_dir(
                            "sentinel", start_round)
                    rank_barrier(mesh)
                    break
                done += c
        finally:
            sim.remove_receiver(tap)
        if bundle is None and self.bundle_path is not None:
            bundle = self.bundle_path  # the watchdog fired mid-chunk
        return state, reports, bundle


def _verdict_perf(sim) -> Optional[dict]:
    """The bundle verdict's ``perf`` section from the simulator's
    :meth:`perf_summary`: None without ``perf=``, and best-effort always
    (the perf context must never mask the failure being recorded)."""
    try:
        summary = (sim.perf_summary()
                   if hasattr(sim, "perf_summary") else None)
    except Exception:
        return None
    if summary is None:
        return None
    last = summary.get("last_run") or {}
    return {
        "last_round_ms": last.get("ms_per_round"),
        "mfu_est": last.get("mfu_est"),
        "hbm_peak_bytes": summary.get("hbm_peak_bytes"),
        "flops_per_round_xla": summary.get("flops_per_round_xla"),
        "compile_count": summary.get("compile_count"),
    }


def _trip_detail(sim, report, idx: int) -> dict:
    """JSON-able summary of the tripped round ``idx`` (0-based within the
    report) for the bundle verdict."""
    detail: dict = {}

    def arr(name):
        v = getattr(report, name, None)
        return None if v is None else np.asarray(v[idx])

    nf = arr("health_nonfinite_params")
    if nf is not None:
        detail["nonfinite_params_total"] = int(nf.sum())
        if nf.sum() > 0:
            names = param_layer_names(sim.handler.layout)
            bad = [names[i] if i < len(names) else str(i)
                   for i in np.nonzero(nf > 0)[0]]
            detail["nonfinite_leaves"] = bad
    flags = arr("health_diverged_per_node")
    if flags is not None:
        detail["diverged_nodes"] = [int(i) for i in
                                    np.nonzero(flags > 0)[0][:32]]
    for name, key in (("health_delta_norm", "delta_norm"),
                      ("health_param_norm_max", "param_norm_max")):
        v = arr(name)
        if v is not None:
            # Strict JSON: a NaN vital serializes as null.
            detail[key] = float(v) if np.isfinite(v) else None
    return detail


# -- replay -----------------------------------------------------------------


def localize_first_nonfinite(sim, state, draws=None) -> dict:
    """Re-run ONE round phase by phase on a copy of ``state`` and name the
    first engine phase after which the params hold a non-finite value
    (``"send"``, ``"receive_merge"``, ``"reply"``, else
    ``"eval_or_none"``). ``draws`` (a draw record, or None for a provider
    keyed on the round) sets ``sim.draws`` to the round's start first, so
    the phases draw what the round drew. Only simulators on the base
    round decomposition are localized; a variant whose ``_round`` is its
    own (All2All) reports ``"round"``."""
    from ..checkpoint import clone_state
    from ..simulation.engine import GossipSimulator
    if getattr(type(sim), "_round", None) is not GossipSimulator._round:
        return {"phase": "round"}
    if draws is not None:
        sim.draws.set_state(draws["state"])
    st = clone_state(state)
    spans = _sim_spans(sim)
    r = st.round
    sim._pre_send(st, r)
    sim._snapshot(st, r)
    sim._send_phase(st, r)
    phases = [("send", st.model.params.clone())]
    sim._deliver_phase(st, r)
    phases.append(("receive_merge", st.model.params.clone()))
    sim._reply_phase(st, r)
    phases.append(("reply", st.model.params))
    for phase, params in phases:
        if int(nonfinite_total(params, spans)) > 0:
            return {"phase": phase}
    return {"phase": "eval_or_none"}


def replay_bundle(bundle_dir: str, sim, max_rounds: Optional[int] = None,
                  localize: bool = True) -> dict:
    """Restore a flight-recorder bundle into ``sim`` and replay forward
    until the first tripped round.

    ``sim`` must be built with the SAME configuration as the recorded run
    (the bundle's ``manifest.json`` ``config`` block says what it was),
    with sentinels on. The bundle's draw state goes into ``sim.draws``;
    rounds are replayed one at a time (a chunked run draws what a straight
    one draws), each round's sentinel verdict read back on the host, so
    the first divergent round, parameter leaf and node set are named
    exactly.

    Returns a verdict dict::

        {"first_bad_round": int | None,     # absolute round index
         "trip": "nonfinite" | "divergence" | None,
         "leaf": str | None,                # first non-finite leaf
         "leaf_index": int | None,
         "nodes": [int, ...],               # affected node ids (<= 32)
         "nonfinite_per_leaf": [int, ...],
         "phase": str | None,               # per-phase localization
         "start_round": int,
         "matches_recorded": bool | None}   # against the bundle's verdict
    """
    assert getattr(sim, "sentinels", None) is not None, \
        "replay needs a sentinel-enabled simulator (sentinels=True)"
    from ..checkpoint import clone_state, draw_record, restore_checkpoint

    with open(os.path.join(bundle_dir, "verdict.json")) as fh:
        recorded = json.load(fh)

    template = sim.init_nodes(local_train=False)
    state, _ = restore_checkpoint(os.path.join(bundle_dir, "checkpoint"),
                                  template, sim.draws)
    start_round = int(state.round)

    if max_rounds is None:
        if recorded.get("first_bad_round") is not None:
            max_rounds = recorded["first_bad_round"] - start_round + 1
        else:
            max_rounds = 64
    names = param_layer_names(sim.handler.layout)
    spans = _sim_spans(sim)

    verdict: dict = {"first_bad_round": None, "trip": None, "leaf": None,
                     "leaf_index": None, "nodes": [],
                     "nonfinite_per_leaf": None, "phase": None,
                     "start_round": start_round, "matches_recorded": None}
    for j in range(max_rounds):
        prev, prev_draws = clone_state(state), draw_record(sim.draws)
        state, report = sim.start(state, n_rounds=1)
        if _first_trip_index(report) is None:
            continue
        verdict["first_bad_round"] = start_round + j
        counts = nonfinite_counts(state.model.params, spans).cpu().numpy()
        verdict["nonfinite_per_leaf"] = [int(c) for c in counts]
        if counts.sum() > 0:
            verdict["trip"] = "nonfinite"
            li = int(np.nonzero(counts > 0)[0][0])
            verdict["leaf_index"] = li
            verdict["leaf"] = names[li] if li < len(names) else str(li)
            o, w = spans[li]
            rows = ~torch.isfinite(state.model.params[:, o:o + w]).all(dim=1)
            verdict["nodes"] = [int(i) for i in
                                torch.nonzero(rows).flatten()[:32].tolist()]
            if localize:
                verdict["phase"] = localize_first_nonfinite(
                    sim, prev, prev_draws)["phase"]
        else:
            verdict["trip"] = "divergence"
            flags = np.asarray(report.health_diverged_per_node[0])
            verdict["nodes"] = [int(i) for i in np.nonzero(flags > 0)[0][:32]]
        break
    if recorded.get("first_bad_round") is not None:
        verdict["matches_recorded"] = (
            verdict["first_bad_round"] == recorded["first_bad_round"])
    return verdict
