"""Analysis layer for the eager gossip round.

Counterpart of :mod:`gossipy_tpu.analysis`. Two halves:

- :mod:`~gossipy_tpu_torch.analysis.tracelint`: an AST linter (stdlib
  ``ast``, no new dependencies) whose rule ``host-sync`` lists every read
  that waits for the card on the round's path (``.item()``,
  ``.tolist()``, ``.cpu()``, ``float()`` of a tensor, ``if`` on a tensor,
  ``torch.cuda.synchronize()``), with ``np-in-round`` and the
  registry-completeness checks. ``python -m gossipy_tpu_torch.analysis``
  runs it; the committed ``analysis/baseline.json`` is today's inventory
  of the round's host syncs, so the command fails only on NEW findings;
  ``# tracelint: disable=<rule>`` suppresses a line.

- :mod:`~gossipy_tpu_torch.analysis.program`: the round's program. PyTorch
  compiles nothing, so the program is the op trace of ``n_rounds`` rounds
  of ``start`` (every aten op with its overload, input shapes, dtypes and
  device type, and every kernel entry, in call order), canonicalized and
  fingerprinted. ``assert_identical_program`` is the helper behind every
  "option off (or host-side only) adds no op" check, and
  ``examples/program_gate.py`` drives the JAX gate's feature matrix
  against the committed golden (``analysis/program_golden.json``) and the
  launch gate.

The linter half imports only the stdlib; the program half imports torch
and the engine lazily on first use.
"""

from .tracelint import (  # noqa: F401
    ALL_RULES,
    ROOTS,
    Finding,
    baseline_from_findings,
    filter_baselined,
    load_baseline,
    resolve_roots,
    run_tracelint,
)

_PROGRAM_NAMES = (
    "canonicalize_trace", "fingerprint_text", "record_trace",
    "program_text", "program_fingerprint", "first_divergence",
    "assert_identical_program", "kernel_launch_count", "gate_cases",
)


def __getattr__(name):
    # The program helpers pull in torch and the engine; keep them lazy so
    # pure-lint consumers never pay that import.
    if name in _PROGRAM_NAMES:
        from . import program
        return getattr(program, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
