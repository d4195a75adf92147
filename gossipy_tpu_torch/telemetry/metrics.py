"""Host-side SLO metrics: a labeled Counter/Gauge/Histogram registry.

The port's own copy of ``gossipy_tpu/telemetry/metrics.py`` (the standard
library only; a test holds its code equal to the original's, the package
name in one docstring cross-reference aside): the registry the engine's
``metrics=`` feeds after each finished ``start()`` segment, HOST-side only,
never from inside a round's computation.

Three metric kinds, each a *family* keyed by a label set:

- :class:`Counter` — monotone accumulator (``inc``); merged by sum.
- :class:`Gauge` — last-written value (``set_value``/``inc``/``dec``)
  with a wall-clock stamp; merged last-writer-wins by stamp (the stamp
  makes the merge associative and commutative).
- :class:`Histogram` — fixed log-spaced buckets shared by every child
  (so cross-process merge is a plain vector add), with p50/p90/p99
  estimation by geometric interpolation inside the covering bucket,
  clamped to the observed min/max.

The gauge setter is ``set_value`` and there is no method named ``merge``,
as in the original; the cross-process combinator is the module function
:func:`merge_snapshots`.

Aggregation surface:

- ``registry.snapshot()`` — one JSON-able dict (``METRICS_SCHEMA``);
- :func:`merge_snapshots` — associative/commutative combination of two
  snapshots;
- ``registry.to_openmetrics()`` / :func:`snapshot_to_openmetrics` —
  OpenMetrics/Prometheus text exposition.

Snapshots and the OpenMetrics text of either package read in the other.

Usage::

    from gossipy_tpu_torch.telemetry.metrics import get_registry
    reg = get_registry()
    reg.counter("engine_rounds_total", "simulation rounds completed",
                ("simulator",)).labels(simulator="GossipSimulator").inc(10)
    print(reg.to_openmetrics())
"""

from __future__ import annotations

import json
import math
import re
import threading
import time
from typing import Optional, Sequence

METRICS_SCHEMA = 1

# Default per-family series cap: the cardinality guard. Tenant-labeled
# families in a long-lived service are the realistic way a registry
# balloons; past the cap new label sets collapse into one shared
# overflow series (labels all ``_other_``) so TOTALS stay right while
# memory stays bounded, and the family counts what it dropped.
DEFAULT_MAX_SERIES = 512
OVERFLOW_LABEL = "_other_"

# Fixed log-spaced bucket upper bounds (seconds-flavoured, but unitless):
# 4 per decade from 100 us to 10 ks, ~1.78x resolution. FIXED so that
# histogram merge across processes is a plain per-bucket add — the
# multi-pod prerequisite rules out adaptive buckets.
_DECADES = range(-4, 5)
_MANTISSAS = (1.0, 1.778, 3.162, 5.623)
DEFAULT_BUCKETS = tuple(
    round(m * 10.0 ** d, 10) for d in _DECADES for m in _MANTISSAS)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid metric/label name {name!r}")
    return name


def _label_key(labelnames: Sequence[str], labels: dict) -> tuple:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} != declared {sorted(labelnames)}")
    return tuple(str(labels[n]) for n in labelnames)


class _Child:
    """One series: a concrete label-set of a family."""

    def __init__(self, family: "_Family", key: tuple):
        self.family = family
        self.key = key

    @property
    def labels_dict(self) -> dict:
        return dict(zip(self.family.labelnames, self.key))


class CounterChild(_Child):
    def __init__(self, family, key):
        super().__init__(family, key)
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counters only go up; inc({v})")
        with self.family.registry._lock:
            self.value += float(v)


class GaugeChild(_Child):
    def __init__(self, family, key):
        super().__init__(family, key)
        self.value = 0.0
        self.ts = 0.0   # never written

    def set_value(self, v: float) -> None:
        with self.family.registry._lock:
            self.value = float(v)
            self.ts = time.time()

    def inc(self, v: float = 1.0) -> None:
        with self.family.registry._lock:
            self.value += float(v)
            self.ts = time.time()

    def dec(self, v: float = 1.0) -> None:
        self.inc(-v)


class HistogramChild(_Child):
    def __init__(self, family, key):
        super().__init__(family, key)
        n = len(family.buckets)
        self.counts = [0] * (n + 1)   # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        if math.isnan(v):
            return  # a NaN observation would poison sum forever
        with self.family.registry._lock:
            self.counts[_bucket_index(self.family.buckets, v)] += 1
            self.sum += v
            self.count += 1
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    def quantile(self, q: float) -> Optional[float]:
        """Estimated ``q``-quantile (0..1) from the bucket counts, or
        None when empty. Geometric interpolation inside the covering
        bucket, clamped to the observed [min, max] envelope — accuracy
        is bounded by the ~1.78x bucket resolution (tested against
        numpy in tests/test_metrics_registry.py)."""
        return quantile_from_counts(self.family.buckets, self.counts, q,
                                    lo=self.min, hi=self.max)


def _bucket_index(buckets: tuple, v: float) -> int:
    import bisect
    return bisect.bisect_left(buckets, v)


def quantile_from_counts(buckets: Sequence[float], counts: Sequence[int],
                         q: float, lo: Optional[float] = None,
                         hi: Optional[float] = None) -> Optional[float]:
    """Quantile estimate from (bucket upper bounds, per-bucket counts).

    Works on live children and on snapshot series alike (the status
    board calls it on tailed snapshots). ``lo``/``hi`` are the observed
    min/max when known — the estimate is clamped into that envelope,
    which fixes the degenerate first/last-bucket cases.
    """
    total = sum(counts)
    if total == 0:
        return None
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        cum += c
        if cum >= rank and c:
            if i >= len(buckets):
                # +Inf bucket: no upper bound — the observed max (or the
                # last finite boundary) is the best available answer.
                est = hi if hi is not None else float(buckets[-1])
                break
            upper = float(buckets[i])
            lower = float(buckets[i - 1]) if i else upper / _MANTISSAS[1]
            frac = (rank - (cum - c)) / c
            if lower > 0 and upper > 0:
                est = lower * (upper / lower) ** frac
            else:   # non-positive observations land in bucket 0
                est = lower + (upper - lower) * frac
            break
    else:
        return None
    if lo is not None:
        est = max(est, lo)
    if hi is not None:
        est = min(est, hi)
    return est


_CHILD_CLASSES = {"counter": CounterChild, "gauge": GaugeChild,
                  "histogram": HistogramChild}


class _Family:
    """One named metric: a label schema plus its children (series)."""

    def __init__(self, registry: "MetricsRegistry", name: str, kind: str,
                 help: str, labelnames: Sequence[str],
                 buckets: Optional[Sequence[float]] = None,
                 max_series: int = DEFAULT_MAX_SERIES):
        self.registry = registry
        self.name = _check_name(name)
        self.kind = kind
        self.help = help
        self.labelnames = tuple(_check_name(n) for n in labelnames)
        self.max_series = int(max_series)
        self.overflowed = 0
        if kind == "histogram":
            self.buckets = tuple(sorted(float(b) for b in
                                        (buckets or DEFAULT_BUCKETS)))
            if not self.buckets:
                raise ValueError("histogram needs at least one bucket")
        else:
            self.buckets = None
        self._children: dict[tuple, _Child] = {}

    def labels(self, **labels) -> _Child:
        """The child for this label set (created on first use). Past
        ``max_series`` distinct label sets, NEW sets collapse into one
        shared overflow child (every label ``_other_``) — totals stay
        correct, memory stays bounded, ``overflowed`` counts the
        collapses."""
        key = _label_key(self.labelnames, labels)
        with self.registry._lock:
            child = self._children.get(key)
            if child is not None:
                return child
            if len(self._children) >= self.max_series:
                self.overflowed += 1
                key = tuple(OVERFLOW_LABEL for _ in self.labelnames)
                child = self._children.get(key)
                if child is not None:
                    return child
            child = _CHILD_CLASSES[self.kind](self, key)
            self._children[key] = child
            return child

    # Zero-label sugar: counter("x").inc() etc. without .labels().
    def _default(self) -> _Child:
        if self.labelnames:
            raise ValueError(
                f"{self.name} declares labels {self.labelnames}; "
                "use .labels(...)")
        return self.labels()

    def inc(self, v: float = 1.0) -> None:
        self._default().inc(v)

    def dec(self, v: float = 1.0) -> None:
        self._default().dec(v)

    def set_value(self, v: float) -> None:
        self._default().set_value(v)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    def quantile(self, q: float) -> Optional[float]:
        return self._default().quantile(q)

    def series(self) -> list:
        return list(self._children.values())

    def _snapshot(self) -> dict:
        out: dict = {"type": self.kind, "help": self.help,
                     "labelnames": list(self.labelnames),
                     "max_series": self.max_series,
                     "overflowed": self.overflowed}
        if self.kind == "histogram":
            out["buckets"] = list(self.buckets)
        rows = []
        for child in self._children.values():
            row: dict = {"labels": child.labels_dict}
            if self.kind == "counter":
                row["value"] = child.value
            elif self.kind == "gauge":
                row["value"] = child.value
                row["ts"] = child.ts
            else:
                row.update({"counts": list(child.counts),
                            "sum": child.sum, "count": child.count,
                            "min": child.min, "max": child.max})
            rows.append(row)
        rows.sort(key=lambda r: tuple(sorted(r["labels"].items())))
        out["series"] = rows
        return out


class MetricsRegistry:
    """A process-local collection of metric families.

    Thread-safe (one coarse lock — the hot path is a dict hit plus a
    float add; contention is not a concern at host-control-plane rates).
    The module-level default registry (:func:`get_registry`) is what the
    engine, the service scheduler and the CLIs share; tests install
    their own via :func:`set_registry`.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._families: dict[str, _Family] = {}

    # -- family accessors (get-or-create; kind/schema mismatches raise) --

    def _family(self, name: str, kind: str, help: str,
                labelnames: Sequence[str],
                buckets: Optional[Sequence[float]] = None,
                max_series: int = DEFAULT_MAX_SERIES) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(self, name, kind, help or name, labelnames,
                              buckets=buckets, max_series=max_series)
                self._families[name] = fam
                return fam
            if fam.kind != kind:
                raise ValueError(
                    f"{name} already registered as {fam.kind}, not {kind}")
            if tuple(labelnames) != fam.labelnames:
                raise ValueError(
                    f"{name} labelnames {fam.labelnames} != "
                    f"{tuple(labelnames)}")
            if kind == "histogram" and buckets is not None and \
                    tuple(sorted(float(b) for b in buckets)) != fam.buckets:
                raise ValueError(f"{name} re-registered with different "
                                 "buckets")
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = (),
                max_series: int = DEFAULT_MAX_SERIES) -> _Family:
        return self._family(name, "counter", help, labelnames,
                            max_series=max_series)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = (),
              max_series: int = DEFAULT_MAX_SERIES) -> _Family:
        return self._family(name, "gauge", help, labelnames,
                            max_series=max_series)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None,
                  max_series: int = DEFAULT_MAX_SERIES) -> _Family:
        return self._family(name, "histogram", help, labelnames,
                            buckets=buckets, max_series=max_series)

    def families(self) -> dict:
        with self._lock:
            return dict(self._families)

    def clear(self) -> None:
        with self._lock:
            self._families.clear()

    # -- aggregation surface --------------------------------------------

    def snapshot(self) -> dict:
        """One JSON-able dict of everything: the unit that gets written
        to ``--metrics-dir``, merged across processes, stamped into
        manifests and carried by the terminal ``metrics_snapshot``
        telemetry event."""
        with self._lock:
            return {"schema": METRICS_SCHEMA, "ts": time.time(),
                    "metrics": {name: fam._snapshot()
                                for name, fam in
                                sorted(self._families.items())}}

    def load_snapshot(self, snap: dict) -> None:
        """Fold a snapshot INTO this registry (live counters add, gauges
        last-writer-win, histogram buckets add) — the in-process face of
        :func:`merge_snapshots`."""
        merged = merge_snapshots(self.snapshot(), snap)
        with self._lock:
            self._families.clear()
            self._load(merged)

    def _load(self, snap: dict) -> None:
        for name, fam_snap in snap.get("metrics", {}).items():
            kind = fam_snap["type"]
            fam = self._family(
                name, kind, fam_snap.get("help", ""),
                fam_snap.get("labelnames", ()),
                buckets=fam_snap.get("buckets"),
                max_series=fam_snap.get("max_series", DEFAULT_MAX_SERIES))
            fam.overflowed = fam_snap.get("overflowed", 0)
            for row in fam_snap.get("series", []):
                child = fam.labels(**row["labels"])
                if kind == "counter":
                    child.value = row["value"]
                elif kind == "gauge":
                    child.value = row["value"]
                    child.ts = row.get("ts", 0.0)
                else:
                    child.counts = list(row["counts"])
                    child.sum = row["sum"]
                    child.count = row["count"]
                    child.min = row.get("min")
                    child.max = row.get("max")

    def to_openmetrics(self) -> str:
        return snapshot_to_openmetrics(self.snapshot())

    def save(self, path: str) -> None:
        """Atomic snapshot write (tmp + rename) so a tailing status
        board never reads a torn file."""
        import os
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self.snapshot(), fh, indent=2)
            fh.write("\n")
        os.replace(tmp, path)


# ---------------------------------------------------------------------------
# Snapshot algebra (pure dict -> dict; the multi-pod merge currency)


def _merge_series(kind: str, rows_a: list, rows_b: list) -> list:
    by_key: dict[tuple, dict] = {}
    for row in rows_a:
        by_key[tuple(sorted(row["labels"].items()))] = \
            json.loads(json.dumps(row))
    for row in rows_b:
        k = tuple(sorted(row["labels"].items()))
        if k not in by_key:
            by_key[k] = json.loads(json.dumps(row))
            continue
        cur = by_key[k]
        if kind == "counter":
            cur["value"] += row["value"]
        elif kind == "gauge":
            # Last-writer-wins by stamp; the (ts, value) tiebreak keeps
            # the pick deterministic, hence the merge associative.
            if (row.get("ts", 0.0), row["value"]) > \
                    (cur.get("ts", 0.0), cur["value"]):
                cur.update(value=row["value"], ts=row.get("ts", 0.0))
        else:
            cur["counts"] = [x + y for x, y in
                             zip(cur["counts"], row["counts"])]
            cur["sum"] += row["sum"]
            cur["count"] += row["count"]
            mins = [m for m in (cur.get("min"), row.get("min"))
                    if m is not None]
            maxs = [m for m in (cur.get("max"), row.get("max"))
                    if m is not None]
            cur["min"] = min(mins) if mins else None
            cur["max"] = max(maxs) if maxs else None
    return [by_key[k] for k in sorted(by_key)]


def merge_snapshots(a: dict, b: dict) -> dict:
    """Combine two registry snapshots into one (associative and
    commutative — fold any number of per-process snapshots in any
    order/grouping and get the same answer; tested). Counters and
    histogram buckets add; gauges take the latest stamp; structural
    mismatches (same name, different type/labelnames/buckets) raise —
    a schema drift between pods is a bug, not something to paper over."""
    out: dict = {"schema": METRICS_SCHEMA,
                 "ts": max(a.get("ts", 0.0), b.get("ts", 0.0)),
                 "metrics": {}}
    names = sorted(set(a.get("metrics", {})) | set(b.get("metrics", {})))
    for name in names:
        fa, fb = a.get("metrics", {}).get(name), \
            b.get("metrics", {}).get(name)
        if fa is None or fb is None:
            out["metrics"][name] = json.loads(json.dumps(fa or fb))
            continue
        for field in ("type", "labelnames"):
            if fa.get(field) != fb.get(field):
                raise ValueError(
                    f"cannot merge {name}: {field} mismatch "
                    f"({fa.get(field)!r} vs {fb.get(field)!r})")
        if fa["type"] == "histogram" and \
                list(fa["buckets"]) != list(fb["buckets"]):
            raise ValueError(f"cannot merge {name}: bucket mismatch")
        merged = {k: fa[k] for k in fa if k != "series"}
        merged["overflowed"] = fa.get("overflowed", 0) + \
            fb.get("overflowed", 0)
        merged["series"] = _merge_series(fa["type"], fa["series"],
                                         fb["series"])
        out["metrics"][name] = merged
    return out


def _om_escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _om_num(v: float) -> str:
    if v != v:
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _om_labels(labels: dict, extra: Optional[tuple] = None) -> str:
    items = sorted(labels.items())
    if extra is not None:
        items = items + [extra]
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_om_escape(str(v))}"'
                          for k, v in items) + "}"


def snapshot_to_openmetrics(snap: dict) -> str:
    """OpenMetrics text exposition of a snapshot (``# HELP``/``# TYPE``
    metadata, counter ``_total`` sample suffix, histogram
    ``_bucket{le=}``/``_sum``/``_count`` expansion, terminal ``# EOF``)
    — the format every Prometheus-compatible scraper ingests."""
    lines: list[str] = []
    for name, fam in sorted(snap.get("metrics", {}).items()):
        kind = fam["type"]
        lines.append(f"# HELP {name} {_om_escape(fam.get('help', name))}")
        lines.append(f"# TYPE {name} {kind}")
        for row in fam.get("series", []):
            labels = row["labels"]
            if kind == "counter":
                suffix = "" if name.endswith("_total") else "_total"
                lines.append(f"{name}{suffix}{_om_labels(labels)} "
                             f"{_om_num(row['value'])}")
            elif kind == "gauge":
                lines.append(f"{name}{_om_labels(labels)} "
                             f"{_om_num(row['value'])}")
            else:
                cum = 0
                for bound, c in zip(list(fam["buckets"]) + [math.inf],
                                    row["counts"]):
                    cum += c
                    le = "+Inf" if bound == math.inf else _om_num(bound)
                    lines.append(
                        f"{name}_bucket{_om_labels(labels, ('le', le))} "
                        f"{cum}")
                lines.append(f"{name}_sum{_om_labels(labels)} "
                             f"{_om_num(row['sum'])}")
                lines.append(f"{name}_count{_om_labels(labels)} "
                             f"{row['count']}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Process-wide default registry (the engine / scheduler / CLI rendezvous)


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Install ``registry`` as the process default; returns the previous
    one (so tests can restore it)."""
    global _REGISTRY
    prev, _REGISTRY = _REGISTRY, registry
    return prev


def observe_engine_run(simulator: str, n_rounds: int, sent: float,
                       failed_by_cause: dict,
                       registry: Optional[MetricsRegistry] = None) -> None:
    """Feed one finished engine segment into the registry: the
    engine-level rounds/sent/failed-by-cause counters, sourced from the
    per-cause :class:`~gossipy_tpu_torch.telemetry.FailureCounts` arrays the
    report already carries. Called HOST-side after the compiled program
    returned — never from a traced region."""
    reg = registry if registry is not None else get_registry()
    reg.counter("engine_rounds_total",
                "simulation rounds completed",
                ("simulator",)).labels(simulator=simulator).inc(n_rounds)
    reg.counter("engine_messages_sent_total",
                "gossip messages generated",
                ("simulator",)).labels(simulator=simulator).inc(sent)
    fam = reg.counter("engine_messages_failed_total",
                      "messages lost, by cause",
                      ("simulator", "cause"))
    for cause, n in failed_by_cause.items():
        fam.labels(simulator=simulator, cause=cause).inc(float(n))
