"""Run ledger: the crash-safe, append-only index of every run artifact.

The port's own copy of ``gossipy_tpu/telemetry/ledger.py`` (the standard
library only; a test holds its code equal to the original's, the package
name in three docstring cross-references aside). Both packages append to
one ledger in one format: ``LEDGER_ENV`` is ``GOSSIPY_TPU_LEDGER`` in
each, and a file written by either reads in the other.

:class:`RunLedger` is ONE fsync'd, CRC-framed JSONL file where every run
appends a compact schema-stamped digest row — run id, wall timestamp,
code version, config fingerprint, backend/device/degraded, headline
metrics (rounds/sec, ``mfu_est``, ``host_blocked_frac``, ``overlap_frac``,
``stream_speedup``, final accuracy, SLO p50/p99), failure causes, and
artifact paths with content hashes.

Crash-safety contract:

- **Appends are atomic and durable**: one framed line per row, written
  with a single ``write`` on an ``O_APPEND`` descriptor and ``fsync``'d
  before :meth:`RunLedger.append` returns.
- **A torn final record is detected and skipped on read, never fatal**:
  each line carries a CRC32 of its JSON payload (``"%08x %s\\n"``); a
  line that fails the frame, the CRC or the parse is counted as skipped
  and reads return every COMPLETE row.
- **The next append repairs the tail**: before writing, a file that does
  not end in a newline is truncated back to its last complete line.

Ingest adapters: :func:`ingest_manifest` (the engine's ``start()``),
:func:`ingest_bench_capsule`, :func:`ingest_trace_report`,
:func:`ingest_ladder`, :func:`ingest_slo_row` and :func:`ingest_bundle`
(flight-recorder bundles, the verdict inline). The engine's opt-in
(:func:`resolve_ledger`): ``ledger=None`` consults the
``GOSSIPY_TPU_LEDGER`` environment variable, ``False`` is off, a path or
a :class:`RunLedger` is explicit. Everything here is HOST-side, after a
run: ledger on and off give bit-identical runs.

:func:`merge_ledgers` is an associative + commutative (and idempotent)
union keyed like :func:`~gossipy_tpu_torch.telemetry.tracing.merge_traces`.
``python3 -m gossipy_tpu_torch.examples.ledger`` is the forensics CLI on
top: ``list`` / ``show`` / ``diff`` / ``trend`` / ``bisect`` / ``merge``.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import uuid
import zlib
from typing import Any, Optional, Union

LEDGER_SCHEMA = 1

# Environment opt-in consulted by :func:`resolve_ledger` (the engine's
# ``ledger=None`` default and the service scheduler): point it at a
# ledger path and every run in the process appends its digest row.
LEDGER_ENV = "GOSSIPY_TPU_LEDGER"

# The headline metric keys a row's ``metrics`` block may carry — the
# queryable currency of `ledger list/diff/trend/bisect`. Producers fill
# whatever subset they measure; absent keys mean "not measured", not 0.
HEADLINE_METRICS = (
    "rounds_per_sec", "mfu_est", "host_blocked_frac", "overlap_frac",
    "stream_speedup", "final_accuracy", "slo_p50_ms", "slo_p99_ms",
)

# Config-snapshot keys excluded from the fingerprint: host-side-only
# observability toggles and the (global, config-independent) partition
# rule table. The fingerprint is shape-signature style — it pins what
# the compiled program and the learning dynamics depend on, so a run
# with tracing on fingerprints identically to the same run without.
_FINGERPRINT_EXCLUDE = frozenset(
    {"metrics", "tracing", "perf", "ledger", "partition_rules"})


def config_fingerprint(config: Optional[dict]) -> Optional[str]:
    """Short stable hash of a config snapshot (host-observability knobs
    excluded — see ``_FINGERPRINT_EXCLUDE``): two rows with the same
    fingerprint ran the same program shape + dynamics config."""
    if not isinstance(config, dict):
        return None
    pinned = {k: v for k, v in config.items()
              if k not in _FINGERPRINT_EXCLUDE}
    canon = json.dumps(_jsonable(pinned), sort_keys=True,
                       separators=(",", ":"))
    return hashlib.sha256(canon.encode()).hexdigest()[:16]


def file_digest(path: str) -> Optional[str]:
    """sha256 of a file's bytes (short form), or None when unreadable —
    artifact rows must never fail because an artifact moved."""
    try:
        h = hashlib.sha256()
        with open(path, "rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 20), b""):
                h.update(chunk)
        return h.hexdigest()[:16]
    except OSError:
        return None


def artifact_entry(path: str) -> dict:
    """``{"path", "sha256"}`` for one artifact file — the content hash
    makes a ledger row's evidence tamper-evident and lets ``diff``
    notice a report that was rewritten after the row landed."""
    return {"path": os.path.abspath(path), "sha256": file_digest(path)}


def code_version() -> Optional[dict]:
    """``{"git_sha", "dirty"}`` of the checkout containing this package,
    or None outside a repo (null-safe everywhere, like
    :func:`~gossipy_tpu_torch.telemetry.manifest.git_revision`)."""
    from .manifest import code_version_block
    return code_version_block()


def _frame(payload: str) -> bytes:
    return (f"{zlib.crc32(payload.encode('utf-8')) & 0xffffffff:08x} "
            f"{payload}\n").encode("utf-8")


def _parse_frame(raw: bytes) -> Optional[dict]:
    """One framed line -> row dict, or None for anything torn/corrupt
    (bad CRC, bad JSON, bad frame) — skipping is the contract, raising
    is not."""
    try:
        text = raw.decode("utf-8")
    except UnicodeDecodeError:
        return None
    if len(text) < 10 or text[8] != " ":
        return None
    crc_hex, payload = text[:8], text[9:]
    try:
        if int(crc_hex, 16) != zlib.crc32(payload.encode("utf-8")):
            return None
        row = json.loads(payload)
    except (ValueError, TypeError):
        return None
    return row if isinstance(row, dict) else None


class RunLedger:
    """One append-only CRC-framed JSONL run index (module docstring has
    the crash-safety contract). Cheap to construct — the file is only
    touched by :meth:`append` / :meth:`read`."""

    def __init__(self, path: str):
        self.path = os.path.abspath(os.fspath(path))
        self._lock = threading.Lock()

    # -- writing -----------------------------------------------------------

    def _repair_tail(self) -> None:
        """Truncate a torn final record (no trailing newline) back to the
        last complete line — the ``kill -9`` mid-append repair."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return
        if size == 0:
            return
        with open(self.path, "rb+") as fh:
            fh.seek(-1, os.SEEK_END)
            if fh.read(1) == b"\n":
                return
            fh.seek(0)
            data = fh.read()
            fh.truncate(data.rfind(b"\n") + 1)
            fh.flush()
            os.fsync(fh.fileno())

    def append(self, row: dict) -> dict:
        """Append one digest row (schema/run_id/ts stamped when absent);
        repairs a torn tail first, writes one framed line, fsyncs, and
        returns the stamped row."""
        row = dict(row)
        row.setdefault("schema", LEDGER_SCHEMA)
        row.setdefault("run_id", uuid.uuid4().hex[:12])
        row.setdefault("ts", time.time())
        payload = json.dumps(_jsonable(row), sort_keys=True,
                             separators=(",", ":"))
        with self._lock:
            parent = os.path.dirname(self.path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._repair_tail()
            fd = os.open(self.path,
                         os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
            try:
                os.write(fd, _frame(payload))
                os.fsync(fd)
            finally:
                os.close(fd)
        return row

    # -- reading -----------------------------------------------------------

    def read(self) -> dict:
        """``{"rows": [...], "skipped": n}`` — every complete row, in
        file order; torn/corrupt lines are counted, never fatal. A
        missing file is an empty ledger."""
        try:
            with open(self.path, "rb") as fh:
                data = fh.read()
        except OSError:
            return {"rows": [], "skipped": 0}
        rows: list = []
        skipped = 0
        for raw in data.split(b"\n"):
            if not raw.strip():
                continue
            row = _parse_frame(raw)
            if row is None:
                skipped += 1
            else:
                rows.append(row)
        return {"rows": rows, "skipped": skipped}

    def rows(self) -> list:
        return self.read()["rows"]

    def find(self, run_id_prefix: str) -> list:
        """Every row whose run id starts with ``run_id_prefix`` (the CLI
        accepts abbreviated ids, git style)."""
        return [r for r in self.rows()
                if str(r.get("run_id", "")).startswith(run_id_prefix)]


def resolve_ledger(ledger: Union[None, bool, str, RunLedger]
                   ) -> Optional[RunLedger]:
    """The engine/service option contract (same shape as ``tracing=``):
    ``None`` consults ``$GOSSIPY_TPU_LEDGER`` (unset = off), ``False``
    is strictly off, a path string opens that file, a :class:`RunLedger`
    is used as-is."""
    if ledger is False:
        return None
    if ledger is None:
        path = os.environ.get(LEDGER_ENV)
        return RunLedger(path) if path else None
    if isinstance(ledger, RunLedger):
        return ledger
    return RunLedger(os.fspath(ledger))


# ---------------------------------------------------------------------------
# Ingest adapters — one call per producer


def _clean_metrics(metrics: Optional[dict]) -> dict:
    out = {}
    for k, v in (metrics or {}).items():
        if v is None:
            continue
        try:
            f = float(v)
        except (TypeError, ValueError):
            continue
        if f == f:  # drop NaN — "not measured", not a value
            out[k] = f
    return out


def headline_from_manifest(manifest: dict) -> dict:
    """Pull whatever headline metrics a RunManifest dict carries: MFU
    from the perf block, host_blocked/overlap from the trace totals,
    SLO percentiles from a service tenant's ``extra.service.slo``."""
    out: dict = {}
    perf = manifest.get("perf") or {}
    last = perf.get("last_run") or {}
    for src in (last, perf):
        if isinstance(src, dict) and src.get("mfu_est") is not None:
            out.setdefault("mfu_est", src["mfu_est"])
    trace = manifest.get("trace") or {}
    if isinstance(trace, dict):
        out["host_blocked_frac"] = trace.get("host_blocked_frac")
        out["overlap_frac"] = trace.get("overlap_frac")
    slo = ((manifest.get("extra") or {}).get("service") or {}).get("slo")
    if isinstance(slo, dict):
        p50 = slo.get("bucket_round_seconds_p50")
        p99 = slo.get("bucket_round_seconds_p99")
        out["slo_p50_ms"] = p50 * 1000.0 if p50 is not None else None
        out["slo_p99_ms"] = p99 * 1000.0 if p99 is not None else None
    return _clean_metrics(out)


def ingest_manifest(ledger: RunLedger, manifest: Any, *,
                    kind: str = "engine",
                    run_id: Optional[str] = None,
                    metrics: Optional[dict] = None,
                    failure: Optional[dict] = None,
                    artifacts: Optional[dict] = None,
                    experiment: Optional[dict] = None,
                    extra: Optional[dict] = None) -> dict:
    """One digest row from a :class:`~gossipy_tpu_torch.telemetry.RunManifest`
    (instance or dict) — the engine ``start()`` and service per-tenant
    adapter. ``metrics`` merges over what the manifest itself carries;
    ``artifacts`` maps name -> path (hashed here); ``experiment`` is the
    replay-pinned ExperimentConfig dict ``ledger bisect`` re-runs."""
    if hasattr(manifest, "to_dict"):
        manifest = manifest.to_dict()
    backend = manifest.get("backend") or {}
    config = manifest.get("config") or {}
    merged = headline_from_manifest(manifest)
    merged.update(_clean_metrics(metrics))
    row = {
        "kind": kind,
        "config": {k: v for k, v in config.items()
                   if k != "partition_rules"},
        "config_fingerprint": config_fingerprint(config),
        "code_version": manifest.get("code_version")
        or ({"git_sha": manifest["git_rev"], "dirty": None}
            if manifest.get("git_rev") else None),
        "backend": backend.get("backend"),
        "device_kind": backend.get("device_kind"),
        "degraded": (backend.get("backend") == "cpu"
                     if backend.get("backend") else None),
        "metrics": merged,
        "failure": failure,
        "artifacts": {name: artifact_entry(path)
                      for name, path in (artifacts or {}).items()},
    }
    if run_id:
        row["run_id"] = run_id
    if experiment is not None:
        row["experiment"] = experiment
    if extra:
        row["extra"] = extra
    return ledger.append(row)


def ingest_bench_capsule(ledger: RunLedger, capsule: Any,
                         source: Optional[str] = None) -> dict:
    """One row from a bench row / bench capsule (path, ``{"n", "parsed":
    row}`` capsule dict, or bare row dict). The original row travels
    whole under ``bench_row`` so ``bench_trend --ledger`` folds it
    losslessly."""
    if isinstance(capsule, str):
        source = source or os.path.basename(capsule)
        with open(capsule) as fh:
            capsule = json.load(fh)
    bench_row = capsule.get("parsed", capsule) \
        if isinstance(capsule, dict) else {}
    raw = bench_row.get("raw") or {}
    metrics = {
        "host_blocked_frac": raw.get("host_blocked_frac"),
        "overlap_frac": raw.get("trace_overlap_frac"),
        "stream_speedup": raw.get("stream_speedup"),
        "mfu_est": raw.get("mfu_est"),
        "slo_p50_ms": raw.get("ttfr_p50_ms"),
        "slo_p99_ms": raw.get("ttfr_p99_ms"),
    }
    metric = str(bench_row.get("metric", ""))
    if metric in ("rounds_per_sec", "throughput"):
        metrics["rounds_per_sec"] = bench_row.get("value")
    if metric.startswith("final_") or metric == "accuracy":
        metrics["final_accuracy"] = bench_row.get("value")
    row = {
        "kind": "bench",
        "config": {k: raw[k] for k in
                   ("n_nodes", "rounds", "data_version") if k in raw},
        "code_version": code_version(),
        "backend": raw.get("backend"),
        "device_kind": raw.get("device_kind"),
        "degraded": bool(raw.get("degraded")) or None,
        "metrics": _clean_metrics(metrics),
        "failure": ({"kind": "degraded",
                     "reason": raw.get("degrade_reason")}
                    if raw.get("degrade_reason") else None),
        "bench_row": bench_row,
    }
    if source:
        row["source"] = source
    return ledger.append(row)


def ingest_trace_report(ledger: RunLedger, report: Any, *,
                        run_id: Optional[str] = None,
                        artifacts: Optional[dict] = None) -> dict:
    """One row from a :func:`~gossipy_tpu_torch.telemetry.tracing.trace_report`
    dict (or a path to one): the critical-path headline
    (host_blocked_frac / overlap_frac) becomes queryable next to the
    throughput rows it explains."""
    if isinstance(report, str):
        path = report
        with open(path) as fh:
            report = json.load(fh)
        artifacts = dict(artifacts or {})
        artifacts.setdefault("trace_report", path)
    totals = report.get("totals") or {}
    row = {
        "kind": "trace",
        "code_version": code_version(),
        "metrics": _clean_metrics({
            "host_blocked_frac": totals.get("host_blocked_frac"),
            "overlap_frac": totals.get("overlap_frac"),
        }),
        "extra": {"n_windows": report.get("n_windows"),
                  "wall_ms": totals.get("wall_ms")},
        "artifacts": {name: artifact_entry(path)
                      for name, path in (artifacts or {}).items()},
    }
    if run_id:
        row["run_id"] = run_id
    return ledger.append(row)


def ingest_ladder(ledger: RunLedger, ladder: Any,
                  path: Optional[str] = None) -> list:
    """One row per scale-ladder rung (dict or ``ladder.json`` path) plus,
    when the ladder ended in a verdict, one failure row naming the rung,
    program and bundle. Returns every appended row."""
    if isinstance(ladder, str):
        path = path or ladder
        with open(ladder) as fh:
            ladder = json.load(fh)
    arts = {"ladder": artifact_entry(path)} if path else {}
    base = {
        "code_version": code_version(),
        "backend": ladder.get("backend"),
        "device_kind": ladder.get("device_kind"),
        "degraded": (ladder.get("backend") == "cpu"
                     if ladder.get("backend") else None),
        "artifacts": arts,
    }
    out = []
    for rung in ladder.get("rungs") or []:
        measured = rung.get("measured") or {}
        ms = measured.get("ms_per_round")
        row = dict(base)
        row.update({
            "kind": "ladder_rung",
            "config": {k: rung[k] for k in
                       ("n_nodes", "nominal_n", "cohort_size", "degree",
                        "history_dtype", "prefetch") if k in rung},
            "metrics": _clean_metrics({
                "rounds_per_sec": 1000.0 / ms if ms else None,
                "mfu_est": measured.get("mfu_est"),
                "stream_speedup": rung.get("stream_speedup"),
            }),
            "failure": ({"kind": "rung_failed"}
                        if rung.get("failed") else None),
        })
        row["config_fingerprint"] = config_fingerprint(row["config"])
        out.append(ledger.append(row))
    verdict = ladder.get("verdict")
    if verdict:
        out.append(ledger.append(dict(base, kind="ladder_verdict",
                                      failure=verdict, metrics={})))
    return out


def ingest_slo_row(ledger: RunLedger, row: Any, *,
                   run_id: Optional[str] = None,
                   artifacts: Optional[dict] = None) -> dict:
    """One row from a ``service_slo`` bench row (``loadgen.py``'s
    ``slo_row.json`` dict or path): tenants/hour + SLO percentiles +
    the trace headline, with the full row under ``bench_row``."""
    if isinstance(row, str):
        path = row
        with open(path) as fh:
            row = json.load(fh)
        artifacts = dict(artifacts or {})
        artifacts.setdefault("slo_row", path)
    raw = row.get("raw") or {}
    out = {
        "kind": "loadgen",
        "config": {k: raw[k] for k in
                   ("n_admitted", "offered_rate_per_hour", "time_scale")
                   if k in raw},
        "code_version": code_version(),
        "backend": raw.get("backend"),
        "device_kind": raw.get("device_kind"),
        "degraded": bool(raw.get("degraded")) or None,
        "metrics": _clean_metrics({
            "slo_p50_ms": raw.get("ttfr_p50_ms"),
            "slo_p99_ms": raw.get("ttfr_p99_ms"),
            "host_blocked_frac": raw.get("host_blocked_frac"),
            "overlap_frac": raw.get("trace_overlap_frac"),
        }),
        "bench_row": row,
        "artifacts": {name: artifact_entry(p)
                      for name, p in (artifacts or {}).items()},
    }
    out["config_fingerprint"] = config_fingerprint(out["config"])
    if run_id:
        out["run_id"] = run_id
    return ledger.append(out)


def ingest_bundle(ledger: RunLedger, bundle_dir: str) -> dict:
    """One failure row from a FlightRecorder bundle directory: the
    verdict travels inline (crashes are first-class ledger rows), the
    bundle + its manifest land as hashed artifacts."""
    verdict: dict = {}
    manifest: dict = {}
    try:
        with open(os.path.join(bundle_dir, "verdict.json")) as fh:
            verdict = json.load(fh)
    except (OSError, json.JSONDecodeError):
        pass
    try:
        with open(os.path.join(bundle_dir, "manifest.json")) as fh:
            manifest = json.load(fh)
    except (OSError, json.JSONDecodeError):
        pass
    backend = manifest.get("backend") or {}
    config = manifest.get("config") or {}
    row = {
        "kind": "bundle",
        "config": {k: v for k, v in config.items()
                   if k != "partition_rules"},
        "config_fingerprint": config_fingerprint(config),
        "code_version": manifest.get("code_version") or code_version(),
        "backend": backend.get("backend"),
        "device_kind": backend.get("device_kind"),
        "metrics": {},
        "failure": {"kind": verdict.get("kind", "unknown"),
                    "verdict": verdict},
        "artifacts": {
            "bundle": {"path": os.path.abspath(bundle_dir),
                       "sha256": None},
            "verdict": artifact_entry(
                os.path.join(bundle_dir, "verdict.json")),
        },
    }
    return ledger.append(row)


# ---------------------------------------------------------------------------
# Merge — the fleet-wide index


def _row_key(row: dict) -> tuple:
    return (row.get("ts") or 0.0, str(row.get("run_id", "")),
            str(row.get("kind", "")),
            json.dumps(row, sort_keys=True, separators=(",", ":")))


def merge_ledgers(a: list, b: list) -> list:
    """Combine two row lists into one fleet-wide index (associative and
    commutative — fold any number of per-process ledgers in any
    order/grouping and get the same answer, the ``merge_snapshots`` /
    ``merge_traces`` contract; rows being unique by run id, the union is
    also idempotent: re-merging a ledger into itself is a no-op). Rows
    are keyed like ``merge_traces`` events — (ts, run id, kind,
    canonical JSON) — deep-copied, deduplicated on the full key, and
    returned sorted. A schema mismatch raises — drift between pods is a
    bug, not something to paper over."""
    seen: dict[tuple, dict] = {}
    for row in list(a) + list(b):
        if row.get("schema") != LEDGER_SCHEMA:
            raise ValueError(
                f"cannot merge: ledger row schema {row.get('schema')!r} "
                f"!= {LEDGER_SCHEMA}")
        seen.setdefault(_row_key(row), json.loads(json.dumps(row)))
    return [seen[k] for k in sorted(seen)]


def merge_ledger_files(out_path: str, paths: list) -> int:
    """Fold several ledger files into one (rewritten atomically via a
    temp file + ``os.replace``, the Tracer.save idiom). Returns the
    merged row count."""
    merged: list = []
    for p in paths:
        merged = merge_ledgers(merged, RunLedger(p).rows())
    tmp = out_path + ".tmp"
    with open(tmp, "w") as fh:
        for row in merged:
            payload = json.dumps(_jsonable(row), sort_keys=True,
                                 separators=(",", ":"))
            fh.write(_frame(payload).decode("utf-8"))
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, out_path)
    return len(merged)


def _jsonable(obj):
    """JSON coercion without importing numpy at module scope — the
    ledger must stay importable (and cheap) in stub environments."""
    from .manifest import _jsonable as coerce
    return coerce(obj)
