"""Engine telemetry: the per-cause failure counters, the gossip-dynamics
probes, the numerics sentinels and the flight recorder, the event sink,
host span tracing, the run manifest, the phase ranges, the metrics
registry, the run ledger and the performance layer (``perf=``).

Exports every name of ``gossipy_tpu.telemetry``."""

from .causes import FAILURE_CAUSES, FailureCounts
from .cost import PEAK_FLOPS, PERF_STAT_KEYS, CostReport, PerfConfig, \
    analytic_round_cost, cost_report_for, differential_phase_attribution, \
    mfu_estimate, peak_flops, perf_event_row, phase_times_from_trace
from .health import BUNDLE_VERSION, HEALTH_STAT_KEYS, FlightRecorder, \
    HealthCarry, SentinelConfig, health_event_row, health_round_stats, \
    localize_first_nonfinite, nonfinite_counts, nonfinite_total, \
    per_node_param_norm, replay_bundle
from .ledger import HEADLINE_METRICS, LEDGER_ENV, LEDGER_SCHEMA, RunLedger, \
    config_fingerprint, ingest_bench_capsule, ingest_bundle, ingest_ladder, \
    ingest_manifest, ingest_slo_row, ingest_trace_report, \
    merge_ledger_files, merge_ledgers, resolve_ledger
from .manifest import MANIFEST_SCHEMA, RunManifest, code_version_block, \
    git_dirty, git_revision
from .metrics import DEFAULT_BUCKETS, METRICS_SCHEMA, MetricsRegistry, \
    get_registry, merge_snapshots, observe_engine_run, \
    quantile_from_counts, set_registry, snapshot_to_openmetrics
from .probes import PROBE_STAT_KEYS, ProbeAccum, ProbeConfig, \
    consensus_stats, param_layer_names, probe_event_row
from .scopes import PHASE_EVAL, PHASE_RECEIVE_MERGE, PHASE_REPLY, \
    PHASE_SEND, PHASE_TRAIN, ROUND_PHASES, phase_scope, phases_in_text, \
    phases_in_trace_dir
from .sink import TelemetryEvent, TelemetrySink, emit_event, get_sink, \
    set_sink
from .tracing import TRACE_SCHEMA, SpanHandle, Tracer, attach_device_spans, \
    ensure_tracer, get_tracer, merge_traces, set_tracer, span, trace_report

__all__ = [
    "FAILURE_CAUSES", "FailureCounts",
    "RunManifest", "MANIFEST_SCHEMA", "git_revision", "git_dirty",
    "code_version_block",
    "RunLedger", "LEDGER_SCHEMA", "LEDGER_ENV", "HEADLINE_METRICS",
    "config_fingerprint", "resolve_ledger",
    "ingest_manifest", "ingest_bench_capsule", "ingest_trace_report",
    "ingest_ladder", "ingest_slo_row", "ingest_bundle",
    "merge_ledgers", "merge_ledger_files",
    "PHASE_SEND", "PHASE_RECEIVE_MERGE", "PHASE_TRAIN", "PHASE_EVAL",
    "PHASE_REPLY", "ROUND_PHASES", "phase_scope", "phases_in_text",
    "phases_in_trace_dir",
    "TelemetryEvent", "TelemetrySink", "emit_event", "get_sink", "set_sink",
    "ProbeConfig", "ProbeAccum", "PROBE_STAT_KEYS", "consensus_stats",
    "param_layer_names", "probe_event_row",
    "SentinelConfig", "HealthCarry", "HEALTH_STAT_KEYS", "BUNDLE_VERSION",
    "FlightRecorder", "health_event_row", "health_round_stats",
    "localize_first_nonfinite", "nonfinite_counts", "nonfinite_total",
    "per_node_param_norm", "replay_bundle",
    "MetricsRegistry", "METRICS_SCHEMA", "DEFAULT_BUCKETS",
    "get_registry", "set_registry", "merge_snapshots",
    "snapshot_to_openmetrics", "quantile_from_counts",
    "observe_engine_run",
    "PerfConfig", "CostReport", "PEAK_FLOPS", "PERF_STAT_KEYS",
    "analytic_round_cost", "cost_report_for",
    "differential_phase_attribution", "mfu_estimate", "peak_flops",
    "perf_event_row", "phase_times_from_trace",
    "Tracer", "SpanHandle", "TRACE_SCHEMA", "span",
    "get_tracer", "set_tracer", "ensure_tracer",
    "attach_device_spans", "merge_traces", "trace_report",
]
