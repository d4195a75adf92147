"""Structured telemetry events: a process-wide sink for engine diagnostics.

The port's own copy of ``gossipy_tpu/telemetry/sink.py`` (the standard
library only; a test holds its code equal to the original's, one comment
word aside): each diagnostic lands here as a :class:`TelemetryEvent` (a
``kind`` tag and a JSON-able payload), kept in an in-memory ring and
optionally mirrored to a JSONL file, so a run harness can assert on them,
a dashboard can tail them, and a post-mortem (the flight recorder's
``events.jsonl``) can read what the engine knew. ``close`` writes the process metrics
registry's snapshot (:mod:`.metrics`) into the mirror.

Usage::

    from gossipy_tpu_torch.telemetry import get_sink, set_sink, TelemetrySink
    set_sink(TelemetrySink(jsonl_path="events.jsonl"))  # optional mirror
    ...build/run simulators...
    for ev in get_sink().events(kind="round"):
        print(ev.kind, ev.data)
"""

from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class TelemetryEvent:
    """One structured diagnostic: a ``kind`` tag plus a JSON-able payload."""

    kind: str
    data: dict
    ts: float = field(default_factory=time.time)

    def to_dict(self) -> dict:
        return {"kind": self.kind, "ts": self.ts, "data": self.data}


class TelemetrySink:
    """Bounded in-memory event ring with an optional JSONL mirror.

    ``maxlen`` bounds host memory (old events fall off the front — the
    ring counts every silent eviction in :attr:`dropped_events`, so
    consumers of the tail, like the flight recorder's trailing-round
    window, can tell a short history from a truncated one);
    ``jsonl_path`` appends every event as one JSON line the moment it is
    emitted (line-buffered, so a crashed run keeps its events).
    """

    def __init__(self, maxlen: int = 1024,
                 jsonl_path: Optional[str] = None):
        self.maxlen = int(maxlen)
        self._events: deque = deque(maxlen=maxlen)
        self._fh = open(jsonl_path, "a", buffering=1) if jsonl_path else None
        self.dropped_events: int = 0

    def emit(self, kind: str, data: dict) -> TelemetryEvent:
        ev = TelemetryEvent(kind=kind, data=dict(data))
        if len(self._events) == self.maxlen:
            # deque(maxlen=) silently evicts the oldest on append; count
            # the loss so ring consumers know the head is gone.
            self.dropped_events += 1
        self._events.append(ev)
        if self._fh is not None:
            self._fh.write(json.dumps(ev.to_dict()) + "\n")
        return ev

    def events(self, kind: Optional[str] = None,
               where: Optional[Callable[[TelemetryEvent], bool]] = None
               ) -> list:
        """Events currently in the ring, optionally filtered by ``kind``
        and/or an arbitrary ``where`` predicate — multi-tenant runners tag
        their events (``data["tenant"]``) and route per-tenant views out
        of the one process ring with
        ``events(where=lambda e: e.data.get("tenant") == tid)``."""
        evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e.kind == kind]
        if where is not None:
            evs = [e for e in evs if where(e)]
        return evs

    def clear(self) -> None:
        self._events.clear()

    def close(self) -> None:
        """Close the JSONL mirror. A terminal ``metrics_snapshot`` line
        first carries the process metrics registry's final state into
        the mirror (when any metric was recorded — a post-mortem reads
        the run's SLO counters next to its last events; mirror-only, so
        the live ring and its ``dropped_events`` accounting are
        untouched), then, when the ring evicted events, a final
        ``sink_closed`` line records the loss (the in-memory tail cannot
        carry what it already dropped)."""
        if self._fh is not None:
            try:
                from .metrics import get_registry
                snap = get_registry().snapshot()
                if snap["metrics"]:
                    # Mirror-only on purpose: close() is terminal, so the
                    # snapshot goes to the durable file, not the live
                    # ring — appending to the ring here would evict real
                    # trailing events and skew dropped_events.
                    self._fh.write(json.dumps(TelemetryEvent(
                        kind="metrics_snapshot",
                        data={"snapshot": snap}).to_dict()) + "\n")
            except Exception:  # a snapshot failure must never block close
                pass
        if self._fh is not None:
            if self.dropped_events:
                self._fh.write(json.dumps(TelemetryEvent(
                    kind="sink_closed",
                    data={"dropped_events": self.dropped_events,
                          "maxlen": self.maxlen}).to_dict()) + "\n")
            self._fh.close()
            self._fh = None


_SINK: TelemetrySink = TelemetrySink()


def get_sink() -> TelemetrySink:
    return _SINK


def set_sink(sink: TelemetrySink) -> TelemetrySink:
    """Install ``sink`` as the process-wide sink; returns the previous one
    (so tests can restore it)."""
    global _SINK
    prev, _SINK = _SINK, sink
    return prev


def emit_event(kind: str, data: dict) -> TelemetryEvent:
    """Emit one structured event to the current process-wide sink."""
    return _SINK.emit(kind, data)
