"""Engine telemetry: the per-cause failure counters, the gossip-dynamics
probes and the numerics sentinels."""

from .causes import FAILURE_CAUSES, FailureCounts
from .health import HEALTH_STAT_KEYS, HealthCarry, SentinelConfig
from .probes import PROBE_STAT_KEYS, ProbeAccum, ProbeConfig

__all__ = ["FAILURE_CAUSES", "FailureCounts",
           "HEALTH_STAT_KEYS", "HealthCarry", "PROBE_STAT_KEYS",
           "ProbeAccum", "ProbeConfig", "SentinelConfig"]
