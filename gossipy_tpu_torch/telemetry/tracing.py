"""Host-side span tracing: one timeline for host segments and device time.

The port's own copy of ``gossipy_tpu/telemetry/tracing.py`` (the standard
library only; a test holds its code equal to the original's, the default
process name ``gossipy_tpu_torch/<pid>`` and two comment words aside). It
makes the host side of a run visible on one timeline: the engine's
``start()`` run and report
phases, checkpoint and flight-recorder writes. The output is an atomic
``trace.json`` in Chrome trace-event format, loadable in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``; :func:`trace_report`
reduces it to the critical-path numbers (per-window ``host_blocked_ms``
/ ``device_ms`` / ``overlap_frac``).

- a process-default instance (:func:`get_tracer` / :func:`set_tracer` /
  :func:`ensure_tracer`) plus explicit instances for tests and multi-run
  isolation;
- thread-safe event recording with per-thread tracks (Chrome ``tid`` +
  ``thread_name`` metadata); timestamps are wall-clock-anchored
  ``perf_counter`` microseconds, so traces from different processes line
  up on one timeline;
- an atomic :meth:`Tracer.save` (tmp + rename: a tailing viewer never
  reads a torn file);
- an associative, commutative :func:`merge_traces` over saved snapshots
  (sorted multiset union of events; structural mismatches raise).

Host-side only: the engine opens its spans around ``start()``'s phases,
never inside a round, and with ``tracing=None`` opens none.
:func:`attach_device_spans` lays a device span under a host window; the
engine gives it the window of the run, closed after the card is
synchronised.

Span API::

    from gossipy_tpu_torch.telemetry import tracing

    tr = tracing.Tracer()
    with tr.span("gather", cat="io", rows=256):
        ...                               # context manager

    @tr.span("load_shard")
    def load_shard(path): ...             # decorator (fresh span per call)

    with tracing.span("checkpoint.save"):  # process-default tracer;
        ...                                # no-op (but still timed) when
                                           # none is installed
    tr.counter_event("queued", value=3)
    tr.save("trace.json")

Every span handle measures its own wall duration (``sp.duration``,
seconds) even when no tracer is installed.
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time
from typing import Any, Callable, Optional

TRACE_SCHEMA = 1

# Reserved Chrome track for bridged device time (real threads map to
# small positive tids; thread_name metadata names them).
DEVICE_TID = 0


# ---------------------------------------------------------------------------
# Span handle (context manager + decorator)


class SpanHandle:
    """One span's lifetime. Always measures wall duration; emits a Chrome
    complete event only when bound to a live tracer.

    Use as a context manager (``with tracer.span("x") as sp: ...`` —
    ``sp.duration`` / ``sp.ts_us`` / ``sp.dur_us`` are readable after the
    block) or as a decorator (``@tracer.span("x")`` — a FRESH span per
    call, so the handle is reusable as a template)."""

    __slots__ = ("_tracer", "_dynamic", "name", "cat", "args",
                 "_t0", "ts_us", "dur_us", "duration")

    def __init__(self, tracer: Optional["Tracer"], name: str,
                 cat: str = "host", dynamic: bool = False,
                 args: Optional[dict] = None):
        self._tracer = tracer
        self._dynamic = dynamic   # resolve the process default at enter
        self.name = name
        self.cat = cat
        self.args = dict(args or {})
        self._t0: Optional[float] = None
        self.ts_us: Optional[float] = None
        self.dur_us: Optional[float] = None
        self.duration: Optional[float] = None   # seconds

    def __enter__(self) -> "SpanHandle":
        if self._dynamic:
            self._tracer = get_tracer()
        tr = self._tracer
        self._t0 = time.perf_counter()
        self.ts_us = tr._now_us() if tr is not None else None
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.duration = time.perf_counter() - self._t0
        self.dur_us = self.duration * 1e6
        tr = self._tracer
        if tr is not None:
            tr.add_complete(self.name, self.ts_us, self.dur_us,
                            cat=self.cat, args=self.args or None)
        return False

    def __call__(self, fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with SpanHandle(self._tracer, self.name, cat=self.cat,
                            dynamic=self._dynamic, args=self.args):
                return fn(*a, **kw)
        return wrapper


# ---------------------------------------------------------------------------
# Tracer


class Tracer:
    """Thread-safe in-memory collector of Chrome trace events.

    Timestamps are microseconds on a wall-clock-anchored monotonic clock:
    ``wall_origin + (perf_counter - perf_origin)`` — perf_counter
    resolution, but comparable across processes, so :func:`merge_traces`
    produces one coherent multi-process timeline."""

    def __init__(self, process_name: Optional[str] = None,
                 pid: Optional[int] = None):
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self.pid = int(pid if pid is not None else os.getpid())
        self.process_name = process_name or f"gossipy_tpu_torch/{self.pid}"
        self._wall0 = time.time()
        self._perf0 = time.perf_counter()
        self._tids: dict[int, int] = {}   # thread ident -> small tid
        self._meta(self.pid, DEVICE_TID, "process_name",
                   {"name": self.process_name})
        self._meta(self.pid, DEVICE_TID, "thread_name", {"name": "device"})

    # -- clock / tracks -------------------------------------------------

    def _now_us(self) -> float:
        return (self._wall0
                + (time.perf_counter() - self._perf0)) * 1e6

    def _meta(self, pid: int, tid: int, name: str, args: dict) -> None:
        with self._lock:
            self._events.append({"ph": "M", "name": name, "pid": pid,
                                 "tid": tid, "ts": 0, "args": args})

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            tid = self._tids.get(ident)
            if tid is None:
                tid = len(self._tids) + 1   # 0 is the device track
                self._tids[ident] = tid
                self._events.append(
                    {"ph": "M", "name": "thread_name", "pid": self.pid,
                     "tid": tid, "ts": 0,
                     "args": {"name": threading.current_thread().name}})
        return tid

    # -- recording ------------------------------------------------------

    def span(self, name: str, cat: str = "host", **args) -> SpanHandle:
        """A span handle bound to this tracer: context manager or
        decorator. ``args`` land in the event's ``args`` dict."""
        return SpanHandle(self, name, cat=cat, args=args)

    def add_complete(self, name: str, ts_us: float, dur_us: float,
                     cat: str = "host", tid: Optional[int] = None,
                     args: Optional[dict] = None) -> None:
        """Record one explicit ``"X"`` complete event — the bridge used
        to lay already-measured device time onto the device track."""
        ev = {"ph": "X", "name": str(name), "cat": str(cat),
              "ts": float(ts_us), "dur": max(float(dur_us), 0.0),
              "pid": self.pid,
              "tid": self._tid() if tid is None else int(tid)}
        if args:
            ev["args"] = dict(args)
        with self._lock:
            self._events.append(ev)

    def counter_event(self, name: str, value: Optional[float] = None,
                      **series) -> None:
        """A ``"C"`` counter sample (Perfetto renders a counter track).
        Either ``value=`` (single series) or keyword series.

        Deliberately NOT named ``counter``: tracelint resolves
        ``obj.counter(...)`` to every repo method of that name, and the
        metrics registry already owns it — a shared name would cross-fire
        metrics-in-trace/trace-in-trace findings (the ``Gauge.set_value``
        precedent)."""
        vals = dict(series)
        if value is not None:
            vals["value"] = float(value)
        with self._lock:
            self._events.append({"ph": "C", "name": str(name),
                                 "ts": self._now_us(), "pid": self.pid,
                                 "tid": DEVICE_TID,
                                 "args": {k: float(v)
                                          for k, v in vals.items()}})

    def instant(self, name: str, cat: str = "host", **args) -> None:
        """A thread-scoped ``"i"`` instant marker (e.g. an arrival)."""
        ev = {"ph": "i", "s": "t", "name": str(name), "cat": str(cat),
              "ts": self._now_us(), "pid": self.pid, "tid": self._tid()}
        if args:
            ev["args"] = dict(args)
        with self._lock:
            self._events.append(ev)

    def begin_async(self, name: str, aid: str, cat: str = "async",
                    **args) -> None:
        """Open an async span (``"b"``) — lifecycles that cross stack
        frames, like a tenant's admission -> first-round -> finish."""
        self._async("b", name, aid, cat, args)

    def async_instant(self, name: str, aid: str, cat: str = "async",
                      **args) -> None:
        """An instant (``"n"``) inside an open async span."""
        self._async("n", name, aid, cat, args)

    def end_async(self, name: str, aid: str, cat: str = "async",
                  **args) -> None:
        self._async("e", name, aid, cat, args)

    def _async(self, ph: str, name: str, aid: str, cat: str,
               args: dict) -> None:
        ev = {"ph": ph, "name": str(name), "cat": str(cat),
              "id": str(aid), "ts": self._now_us(), "pid": self.pid,
              "tid": self._tid()}
        if args:
            ev["args"] = dict(args)
        with self._lock:
            self._events.append(ev)

    # -- aggregation surface --------------------------------------------

    def clear(self) -> None:
        with self._lock:
            self._events = [e for e in self._events if e["ph"] == "M"]

    def snapshot(self) -> dict:
        """One JSON-able Chrome-trace dict (object form): the unit that
        gets saved, merged across processes, and fed to
        ``scripts/trace_report.py``."""
        with self._lock:
            events = [dict(e) for e in self._events]
        return {"schema": TRACE_SCHEMA,
                "displayTimeUnit": "ms",
                "otherData": {"process_name": self.process_name,
                              "pid": self.pid},
                "traceEvents": sorted(events, key=_event_key)}

    def save(self, path: str) -> str:
        """Atomic snapshot write (tmp + rename), like
        ``MetricsRegistry.save`` — a live viewer never reads a torn
        file. Returns ``path``."""
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self.snapshot(), fh)
            fh.write("\n")
        os.replace(tmp, path)
        return path


# ---------------------------------------------------------------------------
# Process default (the metrics get_registry/set_registry pattern — except
# the default starts ABSENT: tracing is opt-in, None means strictly no
# event recording anywhere)

_TRACER: Optional[Tracer] = None


def get_tracer() -> Optional[Tracer]:
    """The process-default tracer, or None when tracing is off."""
    return _TRACER


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install (or clear, with None) the process default; returns the
    previous one so tests/tools can restore it."""
    global _TRACER
    prev, _TRACER = _TRACER, tracer
    return prev


def ensure_tracer() -> Tracer:
    """The process-default tracer, installing a fresh one if absent —
    what ``GossipSimulator(tracing=True)`` / ``GossipService``
    resolve through, so engine, scheduler, checkpoint and
    flight-recorder spans all land in ONE trace."""
    global _TRACER
    if _TRACER is None:
        _TRACER = Tracer()
    return _TRACER


def span(name: str, cat: str = "host",
         tracer: Any = "__default__", **args) -> SpanHandle:
    """Module-level span. With ``tracer=`` explicit (a Tracer or None)
    the handle binds to it; otherwise the PROCESS DEFAULT is resolved at
    enter time (so instrumentation in checkpoint/health sees a tracer
    installed after import). Always measures ``sp.duration``, emits only
    when a tracer is live."""
    if tracer == "__default__":
        return SpanHandle(None, name, cat=cat, dynamic=True, args=args)
    return SpanHandle(tracer, name, cat=cat, args=args)


# ---------------------------------------------------------------------------
# Device-time bridge


def attach_device_spans(tracer: Optional[Tracer], ts_us: float,
                        dur_us: float, phase_ms: Optional[dict] = None,
                        args: Optional[dict] = None) -> None:
    """Lay device time onto the device track under a host run window.

    ``phase_ms`` is the banked per-phase attribution ({phase: ms} from
    ``telemetry.cost.phase_times_from_trace`` or
    ``differential_phase_attribution``): phases are scaled to tile the
    ``[ts_us, ts_us + dur_us]`` window proportionally, end to end, as
    ``device.<phase>`` child spans. Without attribution the window gets
    one ``device.execute`` span — the host-observed execution wait is
    then the device-time proxy ``trace_report`` reduces against."""
    if tracer is None or dur_us <= 0:
        return
    phases = {k: float(v) for k, v in (phase_ms or {}).items()
              if v is not None and float(v) > 0.0}
    if not phases:
        tracer.add_complete("device.execute", ts_us, dur_us,
                            cat="device", tid=DEVICE_TID, args=args)
        return
    total = sum(phases.values())
    t = ts_us
    for phase, ms in phases.items():
        d = dur_us * (ms / total)
        pa = {"attributed_ms": round(ms, 3)}
        if args:
            pa.update(args)
        tracer.add_complete(f"device.{phase.split('.')[-1]}", t, d,
                            cat="device", tid=DEVICE_TID, args=pa)
        t += d


# ---------------------------------------------------------------------------
# Snapshot algebra (pure dict -> dict; the multi-process merge currency)


def _event_key(ev: dict) -> tuple:
    # Total, deterministic order: metadata first (ts 0), then by time;
    # the serialized tiebreak makes the sort independent of input order,
    # which is what makes merge_traces associative AND commutative.
    return (0 if ev.get("ph") == "M" else 1, ev.get("ts", 0.0),
            ev.get("pid", 0), ev.get("tid", 0), ev.get("ph", ""),
            ev.get("name", ""), json.dumps(ev, sort_keys=True))


def merge_traces(a: dict, b: dict) -> dict:
    """Combine two trace snapshots into one multi-process timeline
    (associative and commutative — fold any number of per-process
    snapshots in any order/grouping and get the same answer, the
    ``metrics.merge_snapshots`` contract). Events are a sorted multiset
    union; timestamps are wall-anchored, so tracks interleave truthfully.
    A schema mismatch raises — drift between pods is a bug, not
    something to paper over."""
    for snap in (a, b):
        if snap.get("schema") != TRACE_SCHEMA:
            raise ValueError(
                f"cannot merge: trace schema {snap.get('schema')!r} != "
                f"{TRACE_SCHEMA}")
    events = [json.loads(json.dumps(e))
              for e in list(a.get("traceEvents", []))
              + list(b.get("traceEvents", []))]
    pids = sorted({e.get("pid", 0) for e in events})
    return {"schema": TRACE_SCHEMA,
            "displayTimeUnit": "ms",
            "otherData": {"merged_pids": pids},
            "traceEvents": sorted(events, key=_event_key)}


# ---------------------------------------------------------------------------
# Critical-path / overlap analysis (the scripts/trace_report.py core)

# Spans carrying BOTH these args are "run windows": one host-driven
# segment covering args["rounds"] rounds starting after absolute round
# args["round_start"]. Everything inside the window (same pid, interval
# containment) is attributed to it.
_WINDOW_ARGS = ("round_start", "rounds")

# Host spans of this cat are WAITS (host blocked on device dispatch +
# completion), not host work — excluded from the host-busy union so the
# run wait never counts as host-blocked time.
WAIT_CAT = "host.wait"


def _union(intervals: list[tuple]) -> list[tuple]:
    """Merge overlapping [start, end) intervals; returns disjoint sorted."""
    out: list[tuple] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _total(intervals: list[tuple]) -> float:
    return sum(e - s for s, e in intervals)


def _intersect(xs: list[tuple], ys: list[tuple]) -> list[tuple]:
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        s = max(xs[i][0], ys[j][0])
        e = min(xs[i][1], ys[j][1])
        if s < e:
            out.append((s, e))
        if xs[i][1] <= ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def _subtract(xs: list[tuple], ys: list[tuple]) -> list[tuple]:
    """xs minus ys (both disjoint sorted)."""
    out = []
    for s, e in xs:
        cur = s
        for ys_s, ys_e in ys:
            if ys_e <= cur or ys_s >= e:
                continue
            if ys_s > cur:
                out.append((cur, ys_s))
            cur = max(cur, ys_e)
            if cur >= e:
                break
        if cur < e:
            out.append((cur, e))
    return out


def trace_report(snapshot: dict) -> dict:
    """Reduce a trace snapshot to the critical-path account.

    For every run window (a span with ``round_start``/``rounds`` args —
    cohort segments, engine start() calls, service slices), host work
    and device time inside the window are reduced to interval unions:

    - ``device_ms`` — union length of ``cat="device"`` spans (bridged
      attribution, or the host-observed execution wait proxy);
    - ``host_busy_ms`` — union length of host spans EXCLUDING waits
      (``cat="host.wait"``) and the window span itself;
    - ``overlap_ms`` — host-busy time overlapping device time: host work
      HIDDEN behind compute (the streaming-cohort A/B currency);
    - ``host_blocked_ms`` — host-busy time NOT overlapped: host work on
      the critical path, the time a streaming runner would recover;
    - ``overlap_frac`` — ``overlap_ms / host_busy_ms`` (0.0 when no host
      work): 0 for today's synchronous runners, -> 1 when gather/scatter
      hide behind compute;
    - ``unaccounted_ms`` — window wall not covered by device or blocked
      host time (untraced host gaps; small when instrumentation is
      complete — the smoke's self-consistency check
      ``host_blocked + device + unaccounted == wall`` is exact by
      construction, so asserting ``unaccounted`` small IS asserting
      ``host + device + overlap ~= wall``).

    Window totals are distributed evenly over the window's rounds into
    ``per_round`` rows. ``critical_path`` ranks span names by their
    non-overlapped (critical-path) milliseconds across all windows.

    Attribution is robust to windows that OVERLAP in time (the streaming
    cohort pipeline's ``cohort.segment`` windows span [sample start,
    flush end] of concurrent segments): a span carrying a
    ``window=<round_start>`` arg is attributed to the window with that
    ``round_start`` (nearest in time among duplicates); an untagged span
    falls back to its TIGHTEST containing window (exactly one — the old
    convention double-counted spans under nested windows). Overlap and
    blocked time are computed against the pid-wide device union, not
    just the window's own device spans — a gather for segment t+1 hidden
    behind segment t's run is exactly the overlap streaming is buying.
    """
    events = snapshot.get("traceEvents", [])
    spans = [e for e in events if e.get("ph") == "X"]

    def _is_window(e):
        return all(k in e.get("args", {}) for k in _WINDOW_ARGS)

    windows = sorted((e for e in spans if _is_window(e)), key=_event_key)
    others = [e for e in spans if not _is_window(e)]
    # pid-wide device union: the overlap/blocked context. Inside one
    # window host work may hide behind ANOTHER window's device time.
    dev_all: dict = {}
    for e in others:
        if e.get("cat") == "device":
            dev_all.setdefault(e.get("pid"), []).append(
                (e["ts"], e["ts"] + e["dur"]))
    dev_all = {pid: _union(v) for pid, v in dev_all.items()}

    def _dist(w, e):
        return max(w["ts"] - (e["ts"] + e["dur"]),
                   e["ts"] - (w["ts"] + w["dur"]), 0.0)

    assigned: list[list] = [[] for _ in windows]
    widx = {id(w): i for i, w in enumerate(windows)}
    for e in others:
        pid = e.get("pid")
        tag = (e.get("args") or {}).get("window")
        if tag is not None:
            cands = [w for w in windows if w.get("pid") == pid
                     and int(w["args"]["round_start"]) == int(tag)]
            if cands:
                w = min(cands, key=lambda w: _dist(w, e))
                assigned[widx[id(w)]].append(e)
                continue
        cands = [w for w in windows if w.get("pid") == pid
                 and e["ts"] >= w["ts"]
                 and e["ts"] + e["dur"] <= w["ts"] + w["dur"]]
        if cands:
            w = min(cands, key=lambda w: w["dur"])
            assigned[widx[id(w)]].append(e)

    per_round: list[dict] = []
    window_rows: list[dict] = []
    crit: dict[str, float] = {}
    tot = {"wall_ms": 0.0, "host_busy_ms": 0.0, "host_blocked_ms": 0.0,
           "device_ms": 0.0, "overlap_ms": 0.0, "unaccounted_ms": 0.0}

    for w, inner in zip(windows, assigned):
        w0, w1 = w["ts"], w["ts"] + w["dur"]
        dev = _union([(e["ts"], e["ts"] + e["dur"]) for e in inner
                      if e.get("cat") == "device"])
        dev_ctx = dev_all.get(w.get("pid")) or dev
        host_spans = [e for e in inner
                      if e.get("cat") not in ("device", WAIT_CAT)]
        host = _union([(e["ts"], e["ts"] + e["dur"])
                       for e in host_spans])
        overlap = _intersect(host, dev_ctx)
        blocked = _subtract(host, dev_ctx)
        wall_ms = (w1 - w0) / 1e3
        device_ms = _total(dev) / 1e3
        host_busy_ms = _total(host) / 1e3
        overlap_ms = _total(overlap) / 1e3
        host_blocked_ms = _total(blocked) / 1e3
        unaccounted_ms = max(
            wall_ms - device_ms - host_blocked_ms, 0.0)
        row = {
            "name": w.get("name"),
            "round_start": int(w["args"]["round_start"]),
            "rounds": int(w["args"]["rounds"]),
            "wall_ms": round(wall_ms, 3),
            "host_busy_ms": round(host_busy_ms, 3),
            "host_blocked_ms": round(host_blocked_ms, 3),
            "device_ms": round(device_ms, 3),
            "overlap_ms": round(overlap_ms, 3),
            "overlap_frac": round(overlap_ms / host_busy_ms, 4)
            if host_busy_ms > 0 else 0.0,
            "unaccounted_ms": round(unaccounted_ms, 3),
        }
        window_rows.append(row)
        k = max(row["rounds"], 1)
        for i in range(row["rounds"]):
            per_round.append({
                "round": row["round_start"] + i + 1,
                "wall_ms": round(wall_ms / k, 3),
                "host_blocked_ms": round(host_blocked_ms / k, 3),
                "device_ms": round(device_ms / k, 3),
                "overlap_ms": round(overlap_ms / k, 3),
                "overlap_frac": row["overlap_frac"],
            })
        # Critical-path attribution: each host span's non-device-
        # overlapped time (vs the pid-wide device union), plus the
        # device time itself.
        for e in host_spans:
            iv = _subtract([(e["ts"], e["ts"] + e["dur"])], dev_ctx)
            crit[e["name"]] = crit.get(e["name"], 0.0) + _total(iv) / 1e3
        for e in inner:
            if e.get("cat") == "device":
                crit[e["name"]] = crit.get(e["name"], 0.0) + e["dur"] / 1e3
        for key, v in (("wall_ms", wall_ms),
                       ("host_busy_ms", host_busy_ms),
                       ("host_blocked_ms", host_blocked_ms),
                       ("device_ms", device_ms),
                       ("overlap_ms", overlap_ms),
                       ("unaccounted_ms", unaccounted_ms)):
            tot[key] += v

    totals = {k: round(v, 3) for k, v in tot.items()}
    totals["rounds"] = len(per_round)
    totals["host_blocked_frac"] = (
        round(tot["host_blocked_ms"] / tot["wall_ms"], 4)
        if tot["wall_ms"] > 0 else None)
    totals["overlap_frac"] = (
        round(tot["overlap_ms"] / tot["host_busy_ms"], 4)
        if tot["host_busy_ms"] > 0 else 0.0)
    totals["unaccounted_frac"] = (
        round(tot["unaccounted_ms"] / tot["wall_ms"], 4)
        if tot["wall_ms"] > 0 else None)
    crit_rows = [{"name": n, "ms": round(ms, 3),
                  "frac": round(ms / tot["wall_ms"], 4)
                  if tot["wall_ms"] > 0 else None}
                 for n, ms in sorted(crit.items(), key=lambda kv: -kv[1])]
    return {"schema": TRACE_SCHEMA, "n_windows": len(window_rows),
            "totals": totals, "windows": window_rows,
            "per_round": per_round, "critical_path": crit_rows}
