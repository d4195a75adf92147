"""Named profiler ranges for the round's phases.

Counterpart of ``gossipy_tpu/telemetry/scopes.py``, with the same phase
names and :data:`ROUND_PHASES`. There a phase is a ``jax.named_scope``
whose name lands in the compiled program's op metadata; here a round is
eager PyTorch, and a phase is a ``torch.profiler.record_function`` range
around the phase's host code. Under ``GossipSimulator.start(...,
profile_dir=...)`` the ranges appear in the ``torch.profiler`` trace,
once as CPU ``user_annotation`` events and, on the card, once more as
``gpu_user_annotation`` events spanning the kernels the phase launched,
so a trace shows ``gossipy.send`` / ``gossipy.receive_merge`` /
``gossipy.train`` / ``gossipy.eval`` bands
(:func:`~gossipy_tpu_torch.telemetry.cost.phase_times_from_trace` reduces
them to device ms per phase).

Unlike a named scope, a range is not free: entering one costs a few
microseconds of host time whether a profiler runs or not.

The names are plain attributes (not an enum) so host-side tools can
iterate :data:`ROUND_PHASES` without importing any engine code.
"""

from __future__ import annotations

import torch

PHASE_SEND = "gossipy.send"                    # fire mask, peer draws, scatter
PHASE_RECEIVE_MERGE = "gossipy.receive_merge"  # mailbox read, gather, merge
PHASE_TRAIN = "gossipy.train"                  # the handler's update pass
PHASE_EVAL = "gossipy.eval"                    # local/global evaluation
PHASE_REPLY = "gossipy.reply"                  # PULL/PUSH_PULL reply drain

# The four phases every protocol's round contains (PHASE_REPLY is absent
# from a PUSH round, so it is not in this list).
ROUND_PHASES = (PHASE_SEND, PHASE_RECEIVE_MERGE, PHASE_TRAIN, PHASE_EVAL)


def phase_scope(name: str):
    """A ``torch.profiler.record_function`` range for one round phase
    (context manager)."""
    return torch.profiler.record_function(name)


def phases_in_text(text: str, phases=ROUND_PHASES) -> list:
    """Which phase names appear in ``text`` (any decoded trace content).
    Order follows ``phases``."""
    return [p for p in phases if p in text]


def phases_in_trace_dir(trace_dir: str, phases=ROUND_PHASES) -> list:
    """Which phase names appear anywhere in a ``torch.profiler`` trace
    directory: the exported Chrome JSON files, gzipped or not, scanned as
    bytes (a presence check; :func:`~gossipy_tpu_torch.telemetry.cost.
    phase_times_from_trace` reads the durations)."""
    import gzip
    import os

    needles = {p: p.encode() for p in phases}
    found = set()
    for root, _, files in os.walk(trace_dir):
        for fname in files:
            path = os.path.join(root, fname)
            try:
                with open(path, "rb") as fh:
                    blob = fh.read()
                if fname.endswith(".gz"):
                    blob = gzip.decompress(blob)
            except OSError:
                continue
            for p, needle in needles.items():
                if p not in found and needle in blob:
                    found.add(p)
        if len(found) == len(phases):
            break
    return [p for p in phases if p in found]
