"""Per-cause failure accounting for the simulation engine.

Counterpart of ``gossipy_tpu/telemetry/causes.py``. A message dies in one
of three ways: the send-time drop draw, an offline receiver at delivery,
or a full mailbox cell. A run with ``chaos=`` adds a fourth: a receiver a
scheduled fault forced offline. The causes are mutually exclusive per
message, so their sum equals ``failed`` per round. Counters are Python
ints or 0-d integer tensors (the engine keeps them on the device until
the round's report row is read).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

# Canonical cause ordering. The scheduled-fault "chaos" cause is additive:
# it appears in cause breakdowns only when a run was configured with
# ``chaos=``, so chaos-free reports keep exactly these three keys.
FAILURE_CAUSES = ("drop", "offline", "overflow")

Count = Union[int, torch.Tensor]


class FailureCounts(NamedTuple):
    """Per-cause failed-message counters. ``chaos`` is None on a run
    without ``chaos=`` (no fourth counter at all)."""

    drop: Count = 0
    offline: Count = 0
    overflow: Count = 0
    chaos: Optional[Count] = None

    @classmethod
    def zeros(cls, chaos_on: bool = False) -> "FailureCounts":
        return cls(0, 0, 0, 0 if chaos_on else None)

    # NamedTuple's inherited ``+`` is tuple concatenation: sum elementwise.
    def __add__(self, other: "FailureCounts") -> "FailureCounts":  # type: ignore[override]
        a, b = self.chaos, other.chaos
        chaos = b if a is None else a if b is None else a + b
        return FailureCounts(self.drop + other.drop,
                             self.offline + other.offline,
                             self.overflow + other.overflow, chaos)

    def total(self) -> Count:
        """The ``failed`` counter: the exact sum of the causes."""
        t = self.drop + self.offline + self.overflow
        return t if self.chaos is None else t + self.chaos

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in FAILURE_CAUSES}
