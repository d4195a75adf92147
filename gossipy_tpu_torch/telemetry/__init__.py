"""Engine telemetry: the per-cause failure counters, the gossip-dynamics
probes, the numerics sentinels and the flight recorder, the event sink,
host span tracing and the run manifest."""

from .causes import FAILURE_CAUSES, FailureCounts
from .health import BUNDLE_VERSION, HEALTH_STAT_KEYS, FlightRecorder, \
    HealthCarry, SentinelConfig, localize_first_nonfinite, replay_bundle
from .manifest import MANIFEST_SCHEMA, RunManifest, code_version_block, \
    git_dirty, git_revision
from .probes import PROBE_STAT_KEYS, ProbeAccum, ProbeConfig
from .sink import TelemetryEvent, TelemetrySink, emit_event, get_sink, \
    set_sink
from .tracing import TRACE_SCHEMA, SpanHandle, Tracer, attach_device_spans, \
    ensure_tracer, get_tracer, merge_traces, set_tracer, span, trace_report

__all__ = ["BUNDLE_VERSION", "FAILURE_CAUSES", "FailureCounts",
           "FlightRecorder", "HEALTH_STAT_KEYS", "HealthCarry",
           "MANIFEST_SCHEMA", "PROBE_STAT_KEYS", "ProbeAccum", "ProbeConfig",
           "RunManifest", "SentinelConfig", "SpanHandle", "TRACE_SCHEMA",
           "TelemetryEvent", "TelemetrySink", "Tracer",
           "attach_device_spans", "code_version_block", "emit_event",
           "ensure_tracer", "get_sink", "get_tracer", "git_dirty",
           "git_revision", "localize_first_nonfinite", "merge_traces",
           "replay_bundle", "set_sink", "set_tracer", "span",
           "trace_report"]
