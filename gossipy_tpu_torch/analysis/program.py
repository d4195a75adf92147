"""The round's program: op traces, fingerprints, the gate matrix.

Counterpart of ``gossipy_tpu/analysis/hlo.py``. XLA lowers the JAX
engine's round to one StableHLO program; PyTorch compiles nothing, so
here "the program" is the **op trace** of ``n_rounds`` rounds of
``start``: every aten op the dispatcher runs, recorded by a
``torch.utils._python_dispatch.TorchDispatchMode`` as its overload name
(``aten::mm.default``) with each tensor input's dtype, shape and device
type, and every kernel entry (``kernel::gather_merge_multi``), merged in
call order. The kernels are bound through ``ctypes``, so the dispatch
mode never sees them; the kernel-entry log of ``ops/_build.py``
(:func:`~gossipy_tpu_torch.ops._build.kernel_entry`) is how the trace
does. Scalar arguments keep their type only (``int``, ``float``), not
their value.

Two invariants, as in the JAX package:

1. **An option that is off, or host-side only, costs the round
   nothing**: ``probes=None``, ``sentinels=None``, ``chaos=None``,
   ``cohort=None``, ``fused_merge=False`` and ``perf``/``metrics``/
   ``tracing``/``ledger`` ON trace the identical op sequence as a build
   without them (:func:`assert_identical_program`; the ``identity``
   pairs of :func:`gate_cases`).
2. **The round changes only on purpose**: ``examples/program_gate.py``
   fingerprints the feature grid against ``analysis/program_golden.json``,
   keyed by torch version and device type (an op trace is not stable
   across torch releases, nor between the card, where a kernel is one
   entry, and the host, where its plain version is aten ops).

**The trace depends on the data.** Eager code picks its path from live
values: the compact or the wide deliver by the live receiver count, a
slot's pass only when the slot holds a live message. Both simulators of a
pair are therefore built from the same seeds and run from states made
the same way (:func:`program_text` inits a fresh state per simulator
from ``set_seed(0)``); the comparison is of op sequences, never of
values.

**Canonicalization** (:func:`canonicalize_trace`) drops the
``profiler::`` namespace ops only: the ``record_function`` phase ranges
(``telemetry.scopes``) enter the dispatcher as
``profiler::_record_function_enter_new`` / ``_record_function_exit``.
They are host annotations: no device work and no sync. Everything else
stays, every host sync that goes through the dispatcher included
(``aten::_local_scalar_dense``, the op behind ``.item()`` and
``.tolist()``), so a change to the device work or to those syncs moves
the fingerprint. Blank lines are dropped and whitespace stripped.

**What the trace cannot see.** A sync that goes around the dispatcher
never enters it: ``torch.cuda.synchronize()``, a CUDA event's
``synchronize()`` or ``elapsed_time()``. So the ``perf-on`` and
``tracing-on`` pairs hold the device work of the round, not the
syncs that perf's or a tracer's timing adds on the card. The linter's
``host-sync`` rule (:mod:`.tracelint`) flags ``torch.cuda.synchronize()``
on the round's path from the source; an event's sync is seen by
neither.

**Launch count.** :func:`kernel_launch_count` counts kernel entries per
round EXECUTED; the JAX ``pallas_launch_count`` counts ``pallas_call``
eqns in the traced program, where both branches of a ``lax.cond`` are.
:data:`LAUNCH_MAP` pairs them: unfused 0 and 0; fused multi 1 and 1
(one launch drains the K-slot mailbox); fused compact 2 (the gathered
batch's branch and the wide fallback, both in the program) and 1 (only
the branch taken runs, one launch a round with messages).

**The gate's simulators** (:func:`_make_sim`) are the JAX gate's
configuration (``_N, _D = 16, 6``, ``hlo.py:188-227``). The port's
``fused_merge`` defaults to ``"multi"`` where the JAX engine's default
is ``False``, so :func:`_make_sim` passes ``fused_merge=False`` unless a
case names a deliver: each case means what the JAX case means
(``fused_merge=True`` is ``"multi"`` in both packages).
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

_HASH_LEN = 16
_DROPPED_NAMESPACES = ("profiler::",)


def _describe(x) -> Optional[str]:
    import torch
    if isinstance(x, torch.Tensor):
        return (f"{str(x.dtype).replace('torch.', '')}"
                f"[{','.join(str(d) for d in x.shape)}]@{x.device.type}")
    if isinstance(x, (list, tuple)):
        inner = [d for d in (_describe(v) for v in x) if d is not None]
        return "(" + ",".join(inner) + ")" if inner else type(x).__name__
    if x is None:
        return "None"
    return type(x).__name__


def _op_line(func, args, kwargs) -> str:
    parts = [_describe(a) for a in args]
    parts += [f"{k}={_describe(v)}" for k, v in sorted(kwargs.items())]
    return f"{func.name()}.{func._overloadname}({', '.join(parts)})"


def record_trace(fn) -> tuple[list, object]:
    """Run ``fn()`` under a ``TorchDispatchMode`` that records every aten
    op (:func:`_op_line`) and every kernel entry, in call order. Returns
    ``(op lines, fn's result)``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from ..ops import _build

    lines: list = []

    class _Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            lines.append(_op_line(func, args, kwargs))
            return func(*args, **kwargs)

    def on_entry(name: str) -> None:
        lines.append(f"kernel::{name}")

    _build.add_entry_listener(on_entry)
    try:
        with _Recorder():
            out = fn()
    finally:
        _build.remove_entry_listener(on_entry)
    return lines, out


def canonicalize_trace(text) -> str:
    """Normalize an op trace (a list of lines or their text) for
    fingerprinting: drop the ``profiler::`` range ops and blank lines,
    strip whitespace; keep every other op."""
    lines = text.splitlines() if isinstance(text, str) else list(text)
    out = []
    for line in lines:
        line = line.strip()
        if line and not line.startswith(_DROPPED_NAMESPACES):
            out.append(line)
    return "\n".join(out)


def fingerprint_text(text) -> str:
    """Short stable hash of a canonicalized op trace."""
    canon = canonicalize_trace(text)
    return hashlib.sha256(canon.encode()).hexdigest()[:_HASH_LEN]


def _fresh_state(sim, seed: int = 0):
    from .. import set_seed
    return sim.init_nodes(set_seed(seed))


def program_text(sim, state=None, n_rounds: int = 2) -> str:
    """The canonical op trace of ``n_rounds`` rounds of ``sim.start``
    (on a fresh state from ``set_seed(0)`` when ``state`` is None; a
    given state is cloned, so the caller's is not advanced)."""
    from ..checkpoint import clone_state
    state = _fresh_state(sim) if state is None else clone_state(state)
    lines, _ = record_trace(lambda: sim.start(state, n_rounds=n_rounds))
    return canonicalize_trace(lines)


def program_fingerprint(sim, state=None,
                        n_rounds: int = 2) -> tuple[str, str]:
    """``(fingerprint, canonical text)`` of the simulator's program."""
    canon = program_text(sim, state, n_rounds)
    return hashlib.sha256(canon.encode()).hexdigest()[:_HASH_LEN], canon


def first_divergence(text_a, text_b, label_a: str = "a",
                     label_b: str = "b") -> Optional[dict]:
    """First divergent op between two traces.

    Returns ``None`` when identical, else a dict naming the 1-based
    canonical op index (``"op"``) and both sides' op (one side is
    ``"<end of program>"`` on a pure length divergence)."""
    a = canonicalize_trace(text_a).split("\n")
    b = canonicalize_trace(text_b).split("\n")
    for i, (la, lb) in enumerate(zip(a, b)):
        if la != lb:
            return {"op": i + 1, label_a: la, label_b: lb,
                    f"{label_a}_total": len(a), f"{label_b}_total": len(b)}
    if len(a) != len(b):
        i = min(len(a), len(b))
        return {"op": i + 1,
                label_a: a[i] if i < len(a) else "<end of program>",
                label_b: b[i] if i < len(b) else "<end of program>",
                f"{label_a}_total": len(a), f"{label_b}_total": len(b)}
    return None


def assert_identical_program(sim_a, sim_b, n_rounds: int = 2,
                             label: str = "") -> None:
    """Assert two simulators run the SAME op sequence (each from its own
    fresh state, made the same way), naming the first divergent op on
    failure."""
    ta = program_text(sim_a, None, n_rounds)
    tb = program_text(sim_b, None, n_rounds)
    if ta == tb:
        return
    div = first_divergence(ta, tb, "sim_a", "sim_b")
    raise AssertionError(
        f"program divergence{f' ({label})' if label else ''} at canonical "
        f"op {div['op']}:\n"
        f"  sim_a: {div['sim_a']}\n"
        f"  sim_b: {div['sim_b']}\n"
        f"  ({div['sim_a_total']} vs {div['sim_b_total']} ops)")


def kernel_launch_count(sim, n_rounds: int = 2, state=None) -> float:
    """Kernel entries per round EXECUTED over ``n_rounds`` rounds of
    ``sim.start`` (every kernel of ``ops``; on the card each entry is one
    launch). See :data:`LAUNCH_MAP` for the JAX count it answers."""
    from ..checkpoint import clone_state
    state = _fresh_state(sim) if state is None else clone_state(state)
    before = count_snapshot()
    sim.start(state, n_rounds=n_rounds)
    return sum(count_delta(before)[1].values()) / n_rounds


def kernel_ids() -> tuple:
    """The five kernels (K1-K4, K5) by their counter names."""
    from ..ops import attention, merge
    return (merge.KERNEL, merge.KERNEL_MULTI_DQ, merge.KERNEL_FLAT,
            merge.KERNEL_FLAT_DQ, attention.KERNEL)


def count_snapshot() -> tuple:
    """``(launches, entries)`` of every kernel now, to difference later."""
    from ..ops import _build
    return ({k: _build.LAUNCHES[k] for k in kernel_ids()},
            {k: _build.ENTRIES[k] for k in kernel_ids()})


def count_delta(since: tuple) -> tuple:
    """``(launches, entries)`` of every kernel since ``since``
    (:func:`count_snapshot`), the kernels with none left out."""
    now = count_snapshot()
    return tuple({k: n[k] - s[k] for k in n if n[k] - s[k]}
                 for n, s in zip(now, since))


def launch_mismatches(since: Optional[tuple] = None) -> dict:
    """``{kernel: (launches, entries)}`` for every kernel whose launch
    count differs from its kernel-entry count since ``since``
    (:func:`count_snapshot`; default: since the last
    ``reset_launch_counts``). On the card they must be equal; on the
    host nothing launches."""
    zero = {k: 0 for k in kernel_ids()}
    launches, entries = count_delta(since or (zero, zero))
    return {k: (launches.get(k, 0), entries.get(k, 0))
            for k in kernel_ids()
            if launches.get(k, 0) != entries.get(k, 0)}


# The JAX launch gate's count (static, per round program) against the
# port's (executed, per round): case -> (JAX pallas_launch_count, port
# kernel_launch_count).
LAUNCH_MAP = {"engine/unfused": (0, 0), "engine/fused-multi": (1, 1),
              "engine/fused-compact": (2, 1)}


# ---------------------------------------------------------------------------
# The gate matrix (examples/program_gate.py drives this)

_N, _D = 16, 6


def _make_data(seed=0, n_samples=320):
    import numpy as np
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_samples, _D)).astype(np.float32)
    y = (X @ rng.normal(size=_D) > 0).astype(np.int64)
    return X, y


def _make_sim(cls=None, *, all2all=False, sparse_mix_form=None,
              device=None, **kwargs):
    """The JAX gate's simulator (``hlo.py::_make_sim``): 16 nodes, 6
    features, LogisticRegression under SGD 0.1, batch 8, MERGE_UPDATE,
    PUSH over ``random_regular(16, 4, seed=3)``, delta 20; All2All under
    uniform mixing (sparse forms over a ``SparseTopology``). The deliver
    is the JAX default (``fused_merge=False``) unless named. ``device``
    None is :func:`~gossipy_tpu_torch.resolve_device`'s default: the
    card unless ``GlobalSettings`` names the host."""
    from ..core import (AntiEntropyProtocol, CreateModelMode,
                        SparseTopology, Topology, uniform_mixing)
    from ..data import ClassificationDataHandler, DataDispatcher
    from ..handlers import SGDHandler, losses
    from ..models import LogisticRegression
    from ..optim import sgd
    from ..simulation import All2AllGossipSimulator, GossipSimulator

    X, y = _make_data()
    dh = ClassificationDataHandler(X, y, test_size=0.25, seed=1)
    disp = DataDispatcher(dh, n=_N, eval_on_user=False)
    topo = Topology.random_regular(_N, 4, seed=3)
    handler = SGDHandler(model=LogisticRegression(_D, 2),
                         loss=losses.cross_entropy, optimizer=sgd(0.1),
                         local_epochs=1, batch_size=8, n_classes=2,
                         input_shape=(_D,),
                         create_model_mode=CreateModelMode.MERGE_UPDATE)
    if all2all:
        if sparse_mix_form is not None:
            topo = SparseTopology.random_regular(_N, 4, seed=3)
            kwargs["sparse_mix_form"] = sparse_mix_form
        mixing = uniform_mixing(topo)
        return All2AllGossipSimulator(handler, topo, disp.stacked(),
                                      delta=20, mixing=mixing,
                                      device=device, **kwargs)
    kwargs.setdefault("fused_merge", False)
    cls = cls or GossipSimulator
    return cls(handler, topo, disp.stacked(), delta=20,
               protocol=AntiEntropyProtocol.PUSH, device=device, **kwargs)


def _tmp_ledger():
    import tempfile

    from ..telemetry.ledger import RunLedger
    return RunLedger(os.path.join(tempfile.mkdtemp(prefix="program_ledger_"),
                                  "ledger.jsonl"))


def _small_chaos():
    from ..simulation import ChaosConfig, PartitionEpisode
    half = tuple(range(_N // 2)), tuple(range(_N // 2, _N))
    return ChaosConfig(partitions=(PartitionEpisode(
        components=half, start=1, stop=3),), horizon=4)


def gate_cases(device=None) -> dict:
    """The gate matrix, the JAX gate's case names and configurations, on
    ``device`` (:func:`~gossipy_tpu_torch.resolve_device`: the card
    unless the caller or ``GlobalSettings`` names the host).

    Returns ``{"identity": [(name, build_default, build_off)],
    "fingerprint": [(name, build)], "launch": [(name, build, want)]}``:
    identity pairs must run the identical op sequence; fingerprint cases
    hash against the golden; ``want`` is the port's kernel entries per
    round (:data:`LAUNCH_MAP`). Builders are zero-arg callables."""
    from .. import resolve_device
    device = resolve_device(device)

    def mk(**kw):
        return lambda: _make_sim(device=device, **kw)

    def mk_a(**kw):
        return lambda: _make_sim(all2all=True, device=device, **kw)

    identity = [
        ("engine/probes-off", mk(), mk(probes=None)),
        ("engine/sentinels-off", mk(), mk(sentinels=None)),
        ("engine/chaos-off", mk(), mk(chaos=None)),
        # Active-cohort mode off must be absent (cohort on is a different
        # world: host-driven [C] segments).
        ("engine/cohort-off", mk(), mk(cohort=None)),
        ("engine/perf-off", mk(), mk(perf=None)),
        # perf, metrics, tracing and the ledger are host-side only, so
        # even ON they must add no op.
        ("engine/perf-on", mk(), mk(perf=True)),
        ("engine/metrics-on", mk(), mk(metrics=True)),
        ("engine/tracing-on", mk(), mk(tracing=True)),
        ("engine/ledger-on", mk(), lambda: _make_sim(
            device=device, ledger=_tmp_ledger())),
        # The fused deliver off must be absent: fused_merge=False is the
        # plain deliver the default build runs.
        ("engine/fused-multi-off", mk(), mk(fused_merge=False)),
        ("all2all/sentinels-off", mk_a(), mk_a(sentinels=None)),
    ]
    fingerprint = [
        ("engine/base", mk()),
        ("engine/probes-on", mk(probes=True)),
        ("engine/sentinels-on", mk(sentinels=True)),
        ("engine/chaos-on", lambda: _make_sim(device=device,
                                              chaos=_small_chaos())),
        ("engine/history-bf16", mk(history_dtype="bfloat16")),
        ("engine/history-int8", mk(history_dtype="int8")),
        ("all2all/dense", mk_a()),
        ("all2all/sparse-padded", mk_a(sparse_mix_form="padded")),
        ("all2all/sparse-segment", mk_a(sparse_mix_form="segment")),
        ("engine/fused-multi", mk(fused_merge=True, mailbox_slots=4)),
        ("engine/fused-compact", mk(fused_merge=True, compact_deliver=8,
                                    mailbox_slots=4)),
    ]
    launch = [(name, {"engine/unfused": mk(mailbox_slots=4),
                      "engine/fused-multi": mk(fused_merge=True,
                                               mailbox_slots=4),
                      "engine/fused-compact": mk(
                          fused_merge=True, compact_deliver=8,
                          mailbox_slots=4)}[name], port)
              for name, (_, port) in LAUNCH_MAP.items()]
    return {"identity": identity, "fingerprint": fingerprint,
            "launch": launch}
