"""Observer event stream for simulation runs.

Counterpart of ``gossipy_tpu/simulation/events.py``, a copy of its numpy
code: the same receiver interface, the same per-round payloads and the same
JSON-lines schema, so a file written by either package reads in the other
(``JSONLinesReceiver.parse_line``).

Granularity is per round, not per message: receivers get per-round
aggregates (messages sent / failed / scalars shipped), the probe, health
and chaos rows of runs that compute them, and the mean metrics. Each
simulator instance owns its receiver list.

Two delivery modes (both can be active):

- *replay* (default): after :meth:`GossipSimulator.start` returns, the
  recorded per-round arrays are replayed through every receiver in order.
  The run's counters stay on the device until it ends.
- *live*: when a receiver declares ``live = True``, the engine notifies it
  at each round boundary, which copies that round's counters to the host:
  one host sync a round, paid only while a live receiver is attached. On
  a mesh across ranks each rank's live receivers see the whole
  population's round: the counts a rank takes over its own receivers
  (``offline``, ``overflow``, ``chaos``, the mailbox high-water mark)
  are summed (the mark maxed) over the ranks each round, two
  collectives a round.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class SimulationEventReceiver:
    """Receiver interface (reference simul.py:37-88, per-round granularity).

    Subclass and override any subset; set class attribute ``live = True`` to
    be notified at each round boundary of the running simulation instead of
    replay-after-run.
    """

    live: bool = False

    def update_message(self, round: int, sent: int, failed: int,
                       size: int) -> None:
        """Per-round message traffic: ``sent`` messages generated, ``failed``
        lost (drop / churn / overflow), ``size`` total scalars shipped."""

    def update_failure_causes(self, round: int, causes: dict) -> None:
        """Per-round failure breakdown: ``{"drop": n, "offline": n,
        "overflow": n}`` (telemetry.FAILURE_CAUSES order; values sum to
        ``update_message``'s ``failed``). Fired right after
        ``update_message`` by engines that track causes."""

    def update_single_message(self, failed: bool, msg) -> None:
        """Per-MESSAGE event (the reference's ``update_message(failed,
        msg)`` granularity, simul.py:55-66). Only the sequential engine
        (:mod:`gossipy_tpu_torch.simulation.sequential`) emits these; the
        round engine has no per-message host boundary."""

    def update_probes(self, round: int, probes: dict) -> None:
        """Per-round gossip-dynamics probe values (fired only by runs with
        ``probes=`` enabled; see :mod:`gossipy_tpu_torch.telemetry.probes`).
        ``probes`` carries the JSON-able per-round summary — subsets of
        ``consensus_mean``/``consensus_max``, ``stale_mean``/``stale_max``/
        ``stale_hist``, ``accepted_total``, ``merge_delta``/``train_delta``
        (None when the decomposition is not exact for the simulator) —
        depending on which probes are on. Fired after
        ``update_failure_causes``, live and replayed alike."""

    def update_health(self, round: int, health: dict) -> None:
        """Per-round numerics-sentinel vitals (fired only by runs with
        ``sentinels=`` enabled; see :mod:`gossipy_tpu_torch.telemetry.health`).
        ``health`` carries the JSON-able per-round summary — subsets of
        ``nonfinite_params``/``nonfinite_delta``/``nonfinite_metrics``,
        ``first_bad_slot``, ``mix_nonfinite``, ``diverged``/
        ``param_norm_max``, ``delta_norm``/``delta_hwm``,
        ``mailbox_hwm_run`` and ``trip`` — depending on the active
        :class:`~gossipy_tpu_torch.telemetry.SentinelConfig`. Fired after
        ``update_probes``, live and replayed alike."""

    def update_chaos(self, round: int, chaos: dict) -> None:
        """Per-round scheduled-fault recovery vitals (fired only by runs
        with ``chaos=`` enabled; see
        :mod:`gossipy_tpu_torch.simulation.faults`).
        ``chaos`` carries the JSON-able per-round summary — subsets of
        ``component_gap``/``within_mean``/``active_components`` (when
        consensus probes are also on) and ``failed_chaos`` (the
        scheduled-fault failure cause). Fired after ``update_health``,
        live and replayed alike."""

    def update_perf(self, round: int, perf: dict) -> None:
        """Per-round performance stats (fired only by runs with ``perf=``
        enabled; see :mod:`gossipy_tpu_torch.telemetry.cost`). ``perf``
        carries the JSON-able row — subsets of ``round_ms``
        (host-measured wall ms, uniform within one ``start()`` segment)
        and ``mfu_est`` (null off known cards). The values are HOST-derived after
        the segment finishes, so — unlike the probe/health/chaos rows —
        they replay only (live receivers saw the round before its timing
        existed). Fired after ``update_chaos``."""

    def update_metrics(self, round: int, metrics: dict) -> None:
        """Per-round cumulative engine counters (fired only by runs with
        ``metrics=`` enabled; see
        :mod:`gossipy_tpu_torch.telemetry.metrics`). ``metrics`` carries engine-LIFETIME monotone totals —
        ``rounds_total``, ``sent_total``, ``failed_total`` — so a
        tailing dashboard reads counters straight off the stream.
        Host-derived after the segment finishes (like ``update_perf``),
        so replay-only. Fired after ``update_perf``."""

    def update_cohort(self, round: int, cohort: dict) -> None:
        """Per-round active-cohort accounting (fired only by ``cohort=``
        runs; :mod:`gossipy_tpu_torch.simulation.cohort`).
        ``cohort`` carries ``coverage`` (fraction of the nominal pool any
        cohort has touched so far) and ``active_nodes`` (the materialized
        cohort width C). Host-driven segment loop — replay-only, like
        ``update_perf``. Fired after ``update_metrics``."""

    def update_evaluation(self, round: int, on_user: bool,
                          metrics: dict[str, float]) -> None:
        """Mean metrics for this round (``on_user`` = local test sets)."""

    def update_timestep(self, round: int) -> None:
        """A round finished (the reference's per-``t`` tick, simul.py:161-171)."""

    def update_end(self) -> None:
        """The run finished."""


class SimulationEventSender:
    """Mixin managing per-INSTANCE receivers (cf. reference simul.py:91-177)."""

    def add_receiver(self, receiver: SimulationEventReceiver) -> None:
        self._receivers_list().append(receiver)

    def remove_receiver(self, receiver: SimulationEventReceiver) -> None:
        try:
            self._receivers_list().remove(receiver)
        except ValueError:
            pass

    def _receivers_list(self) -> list[SimulationEventReceiver]:
        if not hasattr(self, "_receivers"):
            self._receivers: list[SimulationEventReceiver] = []
        return self._receivers

    def has_live_receivers(self) -> bool:
        return any(r.live for r in self._receivers_list())

    # -- dispatch ----------------------------------------------------------

    def _notify_round(self, round: int, sent: int, failed: int, size: int,
                      local: Optional[dict], glob: Optional[dict],
                      live_only: bool = False,
                      include_live: bool = False,
                      causes: Optional[dict] = None,
                      probes: Optional[dict] = None,
                      health: Optional[dict] = None,
                      chaos: Optional[dict] = None,
                      perf: Optional[dict] = None,
                      metrics: Optional[dict] = None,
                      cohort: Optional[dict] = None) -> None:
        for r in self._receivers_list():
            if live_only and not r.live:
                continue
            if not live_only and r.live and not include_live:
                continue  # live receivers already saw this round in-run
            r.update_message(round, sent, failed, size)
            if causes is not None:
                r.update_failure_causes(round, causes)
            if probes is not None:
                r.update_probes(round, probes)
            if health is not None:
                r.update_health(round, health)
            if chaos is not None:
                r.update_chaos(round, chaos)
            if perf is not None:
                r.update_perf(round, perf)
            if metrics is not None:
                r.update_metrics(round, metrics)
            if cohort is not None:
                r.update_cohort(round, cohort)
            if local is not None:
                r.update_evaluation(round, True, local)
            if glob is not None:
                r.update_evaluation(round, False, glob)
            r.update_timestep(round)

    def _notify_end(self) -> None:
        for r in self._receivers_list():
            r.update_end()

    def replay_events(self, first_round: int, stats: dict,
                      metric_names: list[str],
                      include_live: bool = False,
                      fire_end: bool = True) -> None:
        """Replay recorded per-round stats (host arrays) through non-live
        receivers, then fire ``update_end``. ``include_live=True`` also
        replays to live receivers — used when the backend cannot run host
        callbacks and the in-run delivery was disabled. ``fire_end=False``
        suppresses the final ``update_end`` — chunked drivers (the service
        scheduler streaming one slice of rounds at a time) replay several
        segments through the same receivers and fire the end themselves."""
        if not self._receivers_list():
            return
        sent = np.asarray(stats["sent"])
        failed = np.asarray(stats["failed"])
        size = np.asarray(stats["size"])
        local = np.asarray(stats["local"])
        glob = np.asarray(stats["global"])
        cause_arrs = None
        if "failed_drop" in stats:
            cause_arrs = {c: np.asarray(stats["failed_" + c])
                          for c in ("drop", "offline", "overflow")}
            if "failed_chaos" in stats:
                cause_arrs["chaos"] = np.asarray(stats["failed_chaos"])
        from ..telemetry.cost import PERF_STAT_KEYS, perf_event_row
        from ..telemetry.health import HEALTH_STAT_KEYS, health_event_row
        from ..telemetry.probes import PROBE_STAT_KEYS, probe_event_row
        from .faults import CHAOS_PROBE_KEYS, chaos_event_row
        probe_arrs = {k: np.asarray(stats[k]) for k in PROBE_STAT_KEYS
                      if k in stats}
        health_arrs = {k: np.asarray(stats[k]) for k in HEALTH_STAT_KEYS
                       if k in stats}
        chaos_arrs = {k: np.asarray(stats[k])
                      for k in ("failed_chaos",) + CHAOS_PROBE_KEYS
                      if k in stats}
        perf_arrs = {k: np.asarray(stats[k]) for k in PERF_STAT_KEYS
                     if k in stats}
        # Host-assembled list of per-round dicts (engine metrics= feed);
        # unlike the array stats above it never transits the device.
        metrics_rows = stats.get("metrics_rows")
        cohort_cov = stats.get("cohort_coverage")
        cohort_active = stats.get("cohort_active_nodes")

        def row(arr, i):
            vals = arr[i]
            if np.all(np.isnan(vals)):
                return None
            return {k: float(v) for k, v in zip(metric_names, vals)}

        for i in range(sent.shape[0]):
            causes = ({c: int(a[i]) for c, a in cause_arrs.items()}
                      if cause_arrs is not None else None)
            probes = probe_event_row({k: a[i] for k, a in probe_arrs.items()})
            health = health_event_row(
                {k: a[i] for k, a in health_arrs.items()})
            chaos = chaos_event_row({k: a[i] for k, a in chaos_arrs.items()})
            perf = perf_event_row({k: a[i] for k, a in perf_arrs.items()})
            metrics = (metrics_rows[i]
                       if metrics_rows is not None and i < len(metrics_rows)
                       else None)
            cohort = None
            if cohort_cov is not None:
                cohort = {"coverage": float(cohort_cov[i]),
                          "active_nodes": (int(cohort_active[i])
                                           if cohort_active is not None
                                           else None)}
            self._notify_round(first_round + i + 1, int(sent[i]),
                               int(failed[i]), int(size[i]),
                               row(local, i), row(glob, i),
                               include_live=include_live, causes=causes,
                               probes=probes, health=health, chaos=chaos,
                               perf=perf, metrics=metrics, cohort=cohort)
        if fire_end:
            self._notify_end()


class ProgressReceiver(SimulationEventReceiver):
    """Live round-progress printer (replaces the reference's rich progress
    bars around the time loop, simul.py:384).

    Each printed line carries the last evaluated metric, the throughput
    over the window since the previous print (rounds/s of host wall-clock
    — meaningful when live; replayed events print the replay rate), and
    the window's failed-message rate, so a long run stays legible
    from the terminal: ``[round 120] accuracy=0.9104 | 812.4 r/s |
    failed 2.1%``.
    """

    live = True

    def __init__(self, every: int = 10, metric: str = "accuracy"):
        import time
        self.every = int(every)
        self.metric = metric
        self._last: dict[str, float] = {}
        self._clock = time.perf_counter
        self._t_window: float = self._clock()
        self._win_sent = 0
        self._win_failed = 0

    def update_message(self, round, sent, failed, size):
        self._win_sent += sent
        self._win_failed += failed

    def update_evaluation(self, round, on_user, metrics):
        if not on_user:
            self._last = metrics

    def update_timestep(self, round):
        if round % self.every == 0:
            val = self._last.get(self.metric)
            extra = f" {self.metric}={val:.4f}" if val is not None else ""
            now = self._clock()
            rate = self.every / max(now - self._t_window, 1e-9)
            fail_pct = (self._win_failed / self._win_sent
                        if self._win_sent else 0.0)
            print(f"[round {round}]{extra} | {rate:.1f} r/s | "
                  f"failed {fail_pct:.1%}", flush=True)
            self._t_window = now
            self._win_sent = self._win_failed = 0


class CallbackReceiver(SimulationEventReceiver):
    """Forward each round as ONE flat dict to a user callable — the
    generic metric-sink the reference lists as an open TODO ("Weights
    and Biases support", README.md:50). Any experiment tracker works
    without a bespoke receiver class::

        import wandb
        sim.add_receiver(CallbackReceiver(wandb.log))
        # or TensorBoard:
        sim.add_receiver(CallbackReceiver(
            lambda row: [writer.add_scalar(k, v, row["round"])
                         for k, v in row.items()
                         if isinstance(v, (int, float))]))

    Per round the callable receives ``{"round", "sent", "failed",
    "size"}`` plus, when the run produces them, ``failed_by_cause``
    (dict), ``local``/``global`` metric dicts, and the ``probes`` /
    ``health`` rows (the same payloads ``update_probes`` /
    ``update_health`` carry). Works replayed (default) or live
    (``live=True``); callable exceptions propagate — wrap your sink if
    it may fail.
    """

    def __init__(self, fn, live: bool = False):
        self.fn = fn
        self.live = bool(live)
        self._row: dict = {}

    def update_message(self, round, sent, failed, size):
        self._row = {"round": round, "sent": sent, "failed": failed,
                     "size": size}

    def update_failure_causes(self, round, causes):
        self._row["failed_by_cause"] = dict(causes)

    def update_probes(self, round, probes):
        self._row["probes"] = dict(probes)

    def update_health(self, round, health):
        self._row["health"] = dict(health)

    def update_chaos(self, round, chaos):
        self._row["chaos"] = dict(chaos)

    def update_perf(self, round, perf):
        self._row["perf"] = dict(perf)

    def update_metrics(self, round, metrics):
        self._row["metrics"] = dict(metrics)

    def update_cohort(self, round, cohort):
        self._row["cohort"] = dict(cohort)

    def update_evaluation(self, round, on_user, metrics):
        self._row["local" if on_user else "global"] = dict(metrics)

    def update_timestep(self, round):
        row, self._row = self._row, {}
        self.fn(row)


class JSONLinesReceiver(SimulationEventReceiver):
    """Append one JSON object per round to a file, kept tool-agnostic:
    any dashboard can tail the .jsonl (for a push-style sink — W&B,
    TensorBoard — use :class:`CallbackReceiver` instead).

    Line schema (``"schema": 7``), one object per round — versions are
    strictly additive, so a reader written against any version parses
    every later one by ignoring unknown keys (and every earlier one via
    :meth:`parse_line`, which fills absent fields with null):

        ======= =================== =====================================
        since   field               meaning
        ======= =================== =====================================
        v1      ``schema``          line-format version int
        v1      ``round``           1-based round number
        v1      ``sent``            messages generated this round
        v1      ``failed``          messages lost this round (all causes)
        v1      ``size``            total scalars shipped this round
        v1      ``local``           ``{metric: mean} | null`` (user tests)
        v1      ``global``          ``{metric: mean} | null`` (global set)
        v2      ``failed_by_cause`` ``{drop, offline, overflow} | null``;
                                    values sum to ``failed``
        v3      ``probes``          gossip-dynamics probe row ``| null``:
                                    subsets of ``consensus_mean``,
                                    ``consensus_max``, ``stale_mean``,
                                    ``stale_max``, ``stale_hist`` (list),
                                    ``accepted_total``, ``merge_delta``,
                                    ``train_delta`` per the run's
                                    ``ProbeConfig`` (null without
                                    ``probes=``)
        v4      ``health``          numerics-sentinel row ``| null``:
                                    subsets of ``nonfinite_params``,
                                    ``nonfinite_delta``,
                                    ``nonfinite_metrics``,
                                    ``first_bad_slot``, ``mix_nonfinite``,
                                    ``diverged``, ``param_norm_max``,
                                    ``delta_norm``, ``delta_hwm``,
                                    ``mailbox_hwm_run``, ``trip`` per the
                                    run's ``SentinelConfig`` (null
                                    without ``sentinels=``)
        v5      ``chaos``           scheduled-fault row ``| null``:
                                    subsets of ``component_gap``,
                                    ``within_mean``,
                                    ``active_components``,
                                    ``failed_chaos`` per the run's
                                    ``ChaosConfig`` (null without
                                    ``chaos=``; ``failed_by_cause`` also
                                    gains a ``chaos`` key on such runs)
        v6      ``perf``            performance row ``| null``: subsets
                                    of ``round_ms`` (host-measured wall
                                    ms, uniform within one ``start()``
                                    segment) and ``mfu_est`` per the
                                    run's ``PerfConfig`` (null without
                                    ``perf=``; replay-only — a live
                                    stream writes null here because the
                                    timing is host-derived after the
                                    segment)
        v8      ``cohort``          active-cohort accounting row
                                    ``| null``: ``coverage`` (fraction
                                    of the nominal pool any cohort has
                                    touched) and ``active_nodes`` (the
                                    materialized cohort width C) — null
                                    without ``cohort=``
        v7      ``metrics``         cumulative engine-counter row
                                    ``| null``: ``rounds_total``,
                                    ``sent_total``, ``failed_total`` —
                                    engine-LIFETIME monotone totals from
                                    the SLO metrics feed (null without
                                    ``metrics=``; replay-only, like
                                    ``perf``). The final registry
                                    snapshot itself travels as the
                                    telemetry sink's terminal
                                    ``metrics_snapshot`` event, not on
                                    round rows
        ======= =================== =====================================

    Works replayed (default) or live (``live=True`` streams rows during the
    run, one host sync a round).

    One instance serves ONE simulator at a time: rows are assembled in a
    mutable per-round buffer, so attaching the same instance to two
    concurrently-running simulators interleaves fields across them. Use it
    as a context manager (``with JSONLinesReceiver(p) as rx: ...``) or call
    :meth:`close` when done.
    """

    SCHEMA = 8

    def __init__(self, path: str, live: bool = False):
        import json
        self._json = json
        self.path = path
        self.live = bool(live)
        self._row: dict = {}
        self._fh = open(path, "a", buffering=1)

    def update_message(self, round, sent, failed, size):
        self._row = {"schema": self.SCHEMA, "round": round, "sent": sent,
                     "failed": failed, "failed_by_cause": None,
                     "size": size, "probes": None, "health": None,
                     "chaos": None, "perf": None, "metrics": None,
                     "cohort": None, "local": None, "global": None}

    def update_failure_causes(self, round, causes):
        self._row["failed_by_cause"] = dict(causes)

    def update_probes(self, round, probes):
        self._row["probes"] = dict(probes)

    def update_health(self, round, health):
        self._row["health"] = dict(health)

    def update_chaos(self, round, chaos):
        self._row["chaos"] = dict(chaos)

    def update_perf(self, round, perf):
        self._row["perf"] = dict(perf)

    def update_metrics(self, round, metrics):
        self._row["metrics"] = dict(metrics)

    def update_cohort(self, round, cohort):
        self._row["cohort"] = dict(cohort)

    def update_evaluation(self, round, on_user, metrics):
        self._row["local" if on_user else "global"] = metrics

    def update_timestep(self, round):
        self._fh.write(self._json.dumps(self._row) + "\n")

    def update_end(self):
        self._fh.flush()

    @classmethod
    def parse_line(cls, line: str) -> dict:
        """Version-tolerant row reader: normalize a v1..v8 line into
        the CURRENT schema's shape (fields a line's version predates come
        back null, unknown future fields pass through untouched). The one
        reader consumers should use instead of re-encoding the version
        history themselves."""
        import json
        row = json.loads(line)
        schema = row.get("schema", 1)
        if schema < 2:
            row.setdefault("failed_by_cause", None)
        if schema < 3:
            row.setdefault("probes", None)
        if schema < 4:
            row.setdefault("health", None)
        if schema < 5:
            row.setdefault("chaos", None)
        if schema < 6:
            row.setdefault("perf", None)
        if schema < 7:
            row.setdefault("metrics", None)
        if schema < 8:
            row.setdefault("cohort", None)
        return row

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False
