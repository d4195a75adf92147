"""Engine telemetry: the per-cause failure counters."""

from .causes import FAILURE_CAUSES, FailureCounts

__all__ = ["FAILURE_CAUSES", "FailureCounts"]
