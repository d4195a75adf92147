"""Per-round performance stats: the names the report and the events read.

Counterpart of the part of ``gossipy_tpu/telemetry/cost.py`` that the
event stream needs (plain Python): the stat keys and the ``update_perf``
row. The engine does not compute them yet (``perf=`` raises).
"""

from __future__ import annotations

import math
from typing import Optional

# Per-round perf stat keys, as the JAX engine attaches them after a timed
# run: the run's amortized ms/round and its MFU estimate.
PERF_STAT_KEYS = (
    "perf_round_ms",
    "perf_mfu_est",
)


def perf_event_row(vals: dict) -> Optional[dict]:
    """The per-round ``update_perf`` observer payload (JSON-able
    scalars) from one round's perf values — absent facilities are simply
    absent keys. Returns None when ``vals`` carries no perf stat."""
    if not vals:
        return None
    row: dict = {}
    if "perf_round_ms" in vals:
        v = float(vals["perf_round_ms"])
        row["round_ms"] = v if math.isfinite(v) else None
    if "perf_mfu_est" in vals:
        v = float(vals["perf_mfu_est"])
        row["mfu_est"] = v if math.isfinite(v) else None
    return row or None
