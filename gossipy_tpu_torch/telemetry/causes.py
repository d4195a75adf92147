"""Per-cause failure accounting for the simulation engine.

Counterpart of ``gossipy_tpu/telemetry/causes.py``. A message dies in one
of three ways: the send-time drop draw, an offline receiver at delivery,
or a full mailbox cell. The causes are mutually exclusive per message, so
``drop + offline + overflow == failed`` holds per round. Counters are
Python ints or 0-d integer tensors (the engine keeps them on the device
until the round's report row is read).
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

FAILURE_CAUSES = ("drop", "offline", "overflow")

Count = Union[int, torch.Tensor]


class FailureCounts(NamedTuple):
    """Per-cause failed-message counters."""

    drop: Count = 0
    offline: Count = 0
    overflow: Count = 0

    @classmethod
    def zeros(cls) -> "FailureCounts":
        return cls(0, 0, 0)

    # NamedTuple's inherited ``+`` is tuple concatenation: sum elementwise.
    def __add__(self, other: "FailureCounts") -> "FailureCounts":  # type: ignore[override]
        return FailureCounts(self.drop + other.drop,
                             self.offline + other.offline,
                             self.overflow + other.overflow)

    def total(self) -> Count:
        """The ``failed`` counter: the exact sum of the causes."""
        return self.drop + self.offline + self.overflow

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in FAILURE_CAUSES}
