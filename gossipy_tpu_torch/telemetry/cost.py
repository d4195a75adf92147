"""Performance observability: peak table, MFU, cost model, attribution.

Counterpart of ``gossipy_tpu/telemetry/cost.py``: the host-side layer
behind the engine's ``perf=``. Nothing here runs inside a round or draws
from the run's draw provider, so a run with ``perf=`` on is bit-identical
to the same run with it off.

- **MFU** (:func:`mfu_estimate` against :data:`PEAK_FLOPS`): the
  per-round FLOPs of :func:`analytic_round_cost` over the measured round
  time, against the card's dense bf16 tensor-core peak. The JAX package
  quotes MFU against the bf16 peak for fp32 configurations too; so does
  the port, so a fp32 run's MFU is the share of the bf16 peak.
- **Analytic cost model** (:func:`analytic_round_cost`): the per-round
  FLOP and byte estimate of the JAX package's, with its keys and
  composition. The handler's update and evaluate programs are counted
  from one node's shapes with ``torch.utils.flop_counter.FlopCounterMode``
  on ``meta`` tensors (matmul and convolution terms, the dominant terms
  the JAX package's jaxpr walker counts); nothing is allocated, launched
  or drawn. The count follows the configuration, not what ran: it stays
  the same whichever implementation (plain or kernel) does the work.
- **Cost reports** (:class:`CostReport`): the JAX package reads XLA's
  cost and memory analysis off each compiled program. The port compiles
  no program, so :func:`cost_report_for` returns None (the JAX function's
  answer where a backend cannot compile ahead of time), and the engine's
  ``cost`` facility banks one report per ``start()`` whose XLA fields stay
  None and whose ``extra`` holds the call's peak allocation
  (``max_memory_allocated``, reset before the call; None on the CPU).
- **Phase attribution** (:func:`differential_phase_attribution`,
  :func:`phase_times_from_trace`): wall time attributed to the round
  phases, by structural differencing or from a ``torch.profiler`` trace
  of ``start(profile_dir=...)`` reduced to device ms per phase.

Like the rest of :mod:`gossipy_tpu_torch.telemetry`, nothing here imports
the engines; the dependency points the other way.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Union

import numpy as np

# Peak dense bf16 tensor-core throughput of each H100 part (NVIDIA's data
# sheets), keyed by torch.cuda.get_device_name(). MFU is quoted against
# the bf16 peak for every compute dtype, as in the JAX package; the
# attention bound of chip_smoke.py reads the same table.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
    "NVIDIA H100 PCIe": 756e12,
    "NVIDIA H100 NVL": 835e12,
}


def current_device_kind() -> Optional[str]:
    """The name of the current CUDA device, or None without one."""
    import torch
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name()


def peak_flops(device_kind: Optional[str] = None) -> Optional[float]:
    """The card's peak FLOP/s from :data:`PEAK_FLOPS`, or None for a
    name the table does not hold (the CPU, another card: MFU is then
    null, never a made-up number). ``device_kind`` defaults to the
    current CUDA device's name."""
    if device_kind is None:
        device_kind = current_device_kind()
        if device_kind is None:
            return None
    return PEAK_FLOPS.get(device_kind)


def mfu_estimate(flops_per_round: Optional[float],
                 seconds_per_round: Optional[float],
                 device_kind: Optional[str] = None) -> Optional[float]:
    """Model-FLOPs-utilization: achieved FLOP/s over the card's peak.
    None whenever any input is unknown (no FLOP count, no timing, no
    peak for this device kind)."""
    if not flops_per_round or not seconds_per_round:
        return None
    peak = peak_flops(device_kind)
    if not peak:
        return None
    return float(flops_per_round / seconds_per_round / peak)


@dataclass(frozen=True)
class PerfConfig:
    """Which performance-observability facilities a simulator runs.

    - ``cost``: bank a :class:`CostReport` per ``start()`` with the
      call's peak device allocation (the JAX package banks XLA's cost and
      memory analysis of each compiled program).
    - ``analytic``: compute the model-side per-round estimate
      (:func:`analytic_round_cost`) for the ``perf`` block.
    - ``timing``: per-run wall timing (ONE card synchronisation per
      ``start()`` call, not per round) stamped as ``perf_round_ms`` /
      ``perf_mfu_est`` report rows and ``update_perf`` events.
    """

    cost: bool = True
    analytic: bool = True
    timing: bool = True

    @classmethod
    def coerce(cls, perf: Union[None, bool, "PerfConfig"]
               ) -> Optional["PerfConfig"]:
        """Normalize the ``perf=`` constructor argument: ``None``/
        ``False`` → off (None), ``True`` → everything at defaults, a
        :class:`PerfConfig` → itself (None when every facility is
        off)."""
        if perf is None or perf is False:
            return None
        if perf is True:
            return cls()
        if isinstance(perf, cls):
            if not (perf.cost or perf.analytic or perf.timing):
                return None
            return perf
        raise TypeError("perf= expects None, bool or PerfConfig; got "
                        f"{type(perf).__name__}")

    def to_dict(self) -> dict:
        return {"cost": self.cost, "analytic": self.analytic,
                "timing": self.timing}


@dataclass
class CostReport:
    """One program's cost record, the JAX package's dataclass.

    ``flops`` / ``bytes_accessed`` and the ``*_bytes`` fields are XLA's
    analysis of a compiled program there; the port compiles none, so they
    stay None and ``extra`` carries what the port measures
    (``max_memory_allocated`` of the ``start()`` call).
    """

    label: str
    n_rounds: Optional[int] = None
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    argument_bytes: Optional[int] = None
    output_bytes: Optional[int] = None
    temp_bytes: Optional[int] = None
    alias_bytes: Optional[int] = None
    generated_code_bytes: Optional[int] = None
    extra: dict = field(default_factory=dict)

    @property
    def peak_bytes(self) -> Optional[int]:
        """Arguments + outputs + temporaries minus the aliased overlap:
        None unless all three are known (never, in the port)."""
        parts = (self.argument_bytes, self.output_bytes, self.temp_bytes)
        if any(p is None for p in parts):
            return None
        return int(sum(parts) - (self.alias_bytes or 0))

    def to_dict(self) -> dict:
        out = {
            "label": self.label,
            "n_rounds": self.n_rounds,
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "alias_bytes": self.alias_bytes,
            "generated_code_bytes": self.generated_code_bytes,
            "peak_bytes": self.peak_bytes,
        }
        if self.extra:
            out["extra"] = self.extra
        return out


def cost_report_for(sim, state=None, key=None, n_rounds: int = 1,
                    label: Optional[str] = None) -> Optional[CostReport]:
    """None: the JAX function compiles the simulator's round program ahead
    of time and reads XLA's analysis of it, and answers None where the
    backend cannot; the port has no program to compile. Use
    :func:`analytic_round_cost` for the per-round FLOPs."""
    return None


# -- analytic cost model ----------------------------------------------------


def count_flops(fn: Callable[[], Any]) -> float:
    """Matmul and convolution FLOPs of ``fn()`` (its autograd backward
    included), by ``FlopCounterMode``: the dominant terms, elementwise
    work excluded, as the JAX package's jaxpr walker counts them."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def _meta_like(t, rows: Optional[int] = 1):
    """Zeros on ``meta`` shaped like ``t`` (its leading axis cut to
    ``rows``, or a new leading axis of 1 when ``rows`` is None)."""
    import torch
    shape = (1,) + tuple(t.shape) if rows is None \
        else (rows,) + tuple(t.shape[1:])
    return torch.zeros(shape, dtype=t.dtype, device="meta")


def _one_node_model(sim):
    """One node's model state on ``meta``: flat params, the optimizer's
    initial state, ages."""
    import torch

    from ..handlers.base import ModelState
    handler = sim.handler
    params = torch.zeros(1, handler.layout.stride, device="meta")
    ages = torch.zeros((1,) + tuple(sim._age_shape()), dtype=torch.int32,
                       device="meta")
    return ModelState(params, handler.init_opt_state(params), ages)


def _update_flops(sim) -> float:
    """FLOPs of one node's local update on its shard's shapes: the epochs
    and every batch of each (a short shard's padded and masked batches
    included, as the JAX update's scan runs them)."""
    import torch
    handler = sim.handler
    data = tuple(_meta_like(t) for t in sim._local_data())
    s = int(data[2].shape[1])
    epochs = handler.orders_per_update()
    perms = None if epochs is None else torch.arange(
        s, device="meta").expand(1, max(int(epochs), 1), s)
    model = _one_node_model(sim)
    return count_flops(lambda: handler.update(model, data, perms))


def _eval_flops(sim, x, y, m) -> float:
    """FLOPs of one node's ``evaluate`` over one test set."""
    from ..handlers.base import ModelState
    model = _one_node_model(sim)
    state = ModelState(model.params, (), None)
    return count_flops(lambda: sim.handler.evaluate(state, (x, y, m)))


def analytic_round_cost(sim) -> Optional[dict]:
    """Model-side per-round FLOP/byte estimate for a simulator, with the
    JAX package's keys and composition: one node's local update
    (:func:`count_flops` on its shard's shapes), times N, plus the merge
    math per delivered message (``4·P``), the evaluation passes and the
    history-ring wire traffic.

    Two FLOP figures, as in the JAX package:

    - ``flops_per_round``: ONE deliver pass and the full evaluation every
      round (the counted-once convention XLA's cost model follows there;
      the MFU numerator);
    - ``flops_per_round_executed``: the deliver pass scaled by the
      topology's mean expected fan-in clipped to ``[1, K]``, and the
      evaluation amortised over ``eval_every``.

    Returns None when the handler resists shape-only counting (an
    estimate failure must never take down a run).
    """
    try:
        P = int(sim.handler.layout.width)
        n = sim.n_nodes
        train_per_node = _update_flops(sim)
    except Exception:
        return None

    merge_per_msg = 4.0 * P
    deliver_pass = float(n) * (train_per_node + merge_per_msg)

    K = int(getattr(sim, "K", 1))
    try:
        lam_mean = float(np.mean(sim._lam_vector()))
    except Exception:
        lam_mean = 1.0
    passes_exec = min(max(lam_mean, 1.0), float(max(K, 1)))

    eval_flops = 0.0
    try:
        n_eval_nodes = (sim._n_eval_nodes()
                        if getattr(sim, "sampling_eval", 0) > 0 else n)
    except Exception:
        n_eval_nodes = n
    data = sim.data
    if getattr(sim, "has_local_test", False):
        try:
            x, y, m = (_meta_like(data[k]) for k in ("xte", "yte", "mte"))
            eval_flops += n_eval_nodes * _eval_flops(sim, x, y, m)
        except Exception:
            pass
    if getattr(sim, "has_global_eval", False):
        try:
            import torch
            x = _meta_like(data["x_eval"], rows=None)
            y = _meta_like(data["y_eval"], rows=None)
            m = torch.ones((1, x.shape[1]), device="meta")
            eval_flops += n_eval_nodes * _eval_flops(sim, x, y, m)
        except Exception:
            pass

    eval_every = float(getattr(sim, "eval_every", 1) or 1)
    flops_counted = deliver_pass + eval_flops
    flops_executed = deliver_pass * passes_exec + eval_flops / eval_every

    bytes_pr = None
    try:
        wire = sim.wire_bytes_per_message()
        epochs = float(getattr(sim.handler, "local_epochs", 1) or 1)
        xtr = sim._local_data()[0]
        data_read = epochs * float(np.prod(tuple(xtr.shape[1:]))) \
            * xtr.element_size() * n
        bytes_pr = float(n) * (lam_mean * wire + 2.0 * 4.0 * P) + data_read
    except Exception:
        pass

    return {
        "flops_per_round": flops_counted,
        "flops_per_round_executed": flops_executed,
        "bytes_per_round": bytes_pr,
        "train_flops_per_node": train_per_node,
        "merge_flops_per_message": merge_per_msg,
        "eval_flops_per_round": eval_flops,
        "expected_deliver_passes": passes_exec,
        "param_count": P,
        "note": "FlopCounterMode dominant terms (matmul/conv) on one "
                "node's shapes; counted-once convention for "
                "flops_per_round, executed estimate scales the deliver "
                "pass by expected fan-in",
    }


# -- per-round perf stats (report schema 6 / update_perf events) ------------

# Per-round perf stat keys, as the engine attaches them after a timed run:
# the run's amortized ms/round and its MFU estimate, uniform within one
# start() call.
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


# -- phase attribution ------------------------------------------------------


def differential_phase_attribution(make_sim: Callable[..., Any],
                                   rounds: int, seed: int = 42) -> dict:
    """Host-timer phase attribution by structural differencing — the
    fallback when no profiler trace is available (and the cross-check
    when one is).

    ``make_sim(**overrides)`` must build the simulator, honoring the
    ``eval_every`` and ``local_epochs`` overrides. Each leg initialises
    its nodes under ``torch.Generator().manual_seed(seed)``, runs
    ``rounds`` rounds to warm up (on a copy of the state) and then the
    same ``rounds`` rounds from the same draws, timed, the card
    synchronised before the clock stops. Three legs are differenced:
    full round, evaluation off (``eval_every`` past the horizon), and a
    doubled local-epoch count (the extra epoch's marginal cost isolates
    one epoch of training). The exchange leg is the remainder, so the
    three phases sum to the full round time EXACTLY by construction.
    """
    import time as _time

    import torch

    from ..checkpoint import clone_state

    def sync(sim) -> None:
        dev = getattr(sim, "device", None)
        if dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def time_one(**overrides) -> float:
        sim = make_sim(**overrides)
        state = sim.init_nodes(torch.Generator().manual_seed(seed))
        drawn = sim.draws.get_state()
        sim.start(clone_state(state), n_rounds=rounds)
        sync(sim)
        sim.draws.set_state(drawn)
        t0 = _time.perf_counter()
        sim.start(state, n_rounds=rounds)
        sync(sim)
        return (_time.perf_counter() - t0) / rounds * 1e3

    full = time_one()
    no_eval = time_one(eval_every=10 * rounds)
    two_epochs = time_one(eval_every=10 * rounds, local_epochs=2)
    train = two_epochs - no_eval  # one epoch's marginal cost
    return {
        "method": "differential",
        "full_ms": full,
        "phases_ms": {
            "eval": full - no_eval,
            "train": train,
            "exchange_and_overhead": no_eval - train,
        },
        "rounds": rounds,
        "note": "steady-state differencing; at small round counts the "
                "legs carry run-to-run noise and can go slightly "
                "negative",
    }


# The trace events that are device work (a kernel, a copy, a fill).
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _intervals(events, cat: str, phases) -> list:
    """``(ts, end, name)`` of the ``cat`` events named after a phase,
    sorted by start."""
    out = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
            e["name"]) for e in events
           if e.get("cat") == cat and e.get("name") in phases]
    out.sort()
    return out


def _deepest(spans: list, starts: list, ts: float, end: float):
    """The phase of the deepest span of ``spans`` (sorted, properly
    nested) enclosing ``[ts, end]``, or None: walking back from the last
    span starting at or before ``ts``, the first that encloses the event
    is the innermost (``gossipy.train`` inside ``gossipy.receive_merge``)."""
    import bisect
    i = bisect.bisect_right(starts, ts) - 1
    while i >= 0:
        s, e, name = spans[i]
        if e >= end:
            return name
        i -= 1
    return None


def _top_level(ops: list) -> list:
    """The ops of one thread not enclosed by another op of it
    (``aten::linear`` holds ``aten::addmm``: only the first counts)."""
    ops = sorted(ops, key=lambda e: (float(e["ts"]), -float(e["dur"])))
    out, end = [], -math.inf
    for e in ops:
        ts = float(e["ts"])
        if ts >= end:
            out.append(e)
            end = ts + float(e["dur"])
        elif ts + float(e["dur"]) > end:
            # A partial overlap is clock jitter at a boundary: the op is
            # inside its predecessor's span as far as the trace can say.
            continue
    return out


def _phase_sums(events: list, phases, detail: Optional[dict]
                ) -> Optional[dict]:
    """``{phase: µs}`` of one trace's events, or None when it holds no
    phase-attributed work. Device work (kernels, copies, fills) is summed
    by the deepest enclosing GPU phase annotation, or, where the trace
    has none, by the deepest CPU phase annotation around the runtime call
    that launched it (its correlation id). A trace without device work
    sums the top-level CPU ops by the deepest enclosing CPU phase
    annotation. The annotations' own durations are never summed."""
    sums = {p: 0.0 for p in phases}
    device = [e for e in events if e.get("cat") in _DEVICE_CATS
              and e.get("dur")]
    found = False
    if device:
        gpu = _intervals(events, "gpu_user_annotation", phases)
        if gpu:
            route = "gpu_user_annotation"
            starts = [s for s, _, _ in gpu]
            for e in device:
                ts = float(e["ts"])
                hit = _deepest(gpu, starts, ts, ts + float(e["dur"]))
                if hit is not None:
                    sums[hit] += float(e["dur"])
                    found = True
        else:
            route = "correlation"
            launches = {}
            for e in events:
                args = e.get("args") or {}
                if e.get("cat") == "cuda_runtime" and "correlation" in args:
                    launches[args["correlation"]] = e
            by_thread = _cpu_annotations(events, phases)
            for e in device:
                corr = (e.get("args") or {}).get("correlation")
                call = launches.get(corr)
                if call is None:
                    continue
                spans = by_thread.get((call.get("pid"), call.get("tid")))
                if not spans:
                    continue
                ts = float(call["ts"])
                hit = _deepest(spans[0], spans[1], ts,
                               ts + float(call.get("dur", 0.0)))
                if hit is not None:
                    sums[hit] += float(e["dur"])
                    found = True
    else:
        route = "cpu"
        by_thread = _cpu_annotations(events, phases)
        ops: dict = {}
        for e in events:
            if e.get("cat") == "cpu_op" and e.get("dur") is not None:
                ops.setdefault((e.get("pid"), e.get("tid")), []).append(e)
        for key, spans in by_thread.items():
            for e in _top_level(ops.get(key, [])):
                ts = float(e["ts"])
                hit = _deepest(spans[0], spans[1], ts, ts + float(e["dur"]))
                if hit is not None:
                    sums[hit] += float(e["dur"])
                    found = True
    if not found:
        return None
    if detail is not None:
        detail["route"] = route
    return sums


def _cpu_annotations(events: list, phases) -> dict:
    """The CPU phase annotations by ``(pid, tid)``: ``(spans, starts)``."""
    by_thread: dict = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") in phases:
            by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    out = {}
    for key, evs in by_thread.items():
        spans = _intervals(evs, "user_annotation", phases)
        out[key] = (spans, [s for s, _, _ in spans])
    return out


def phase_times_from_trace(trace_dir: str, phases=None,
                           detail: Optional[dict] = None
                           ) -> Optional[dict]:
    """Reduce a ``torch.profiler`` trace directory (the Chrome JSON that
    ``start(profile_dir=...)`` exports, gzipped or not) to per-phase
    milliseconds of :data:`~gossipy_tpu_torch.telemetry.scopes.
    ROUND_PHASES`.

    Each event is attributed to the DEEPEST enclosing phase range
    (``gossipy.train`` nests inside ``gossipy.receive_merge``): on the
    card the device events (kernels, copies, fills) by the GPU copies of
    the ranges (``gpu_user_annotation``), or, where the trace carries
    none, through the launching runtime call's correlation id to the CPU
    range around it; on the CPU the top-level CPU ops by the CPU ranges.
    ``detail``, when given, gets ``route`` (``"gpu_user_annotation"``,
    ``"correlation"`` or ``"cpu"``) and ``file``. One file's account
    only: the first file (in sorted order) that holds phase-attributed
    work. Returns ``{phase: ms}`` for the phases seen, or None when no
    parsable trace or no phase-attributed event exists."""
    import gzip
    import json
    import os

    if phases is None:
        from .scopes import ROUND_PHASES
        phases = ROUND_PHASES
    phases = tuple(phases)

    def one_file(path: str, gz: bool) -> Optional[dict]:
        try:
            if gz:
                with gzip.open(path, "rt") as fh:
                    doc = json.load(fh)
            else:
                with open(path) as fh:
                    doc = json.load(fh)
        except Exception:
            return None
        events = doc.get("traceEvents", doc) if isinstance(doc, dict) \
            else doc
        if not isinstance(events, list):
            return None
        events = [e for e in events if isinstance(e, dict)
                  and e.get("ph") == "X" and "ts" in e]
        sums = _phase_sums(events, phases, detail)
        if sums is None:
            return None
        if detail is not None:
            detail["file"] = path
        return {p: v / 1e3 for p, v in sums.items() if v > 0.0}

    for root, dirs, files in os.walk(trace_dir):
        dirs.sort()
        for fname in sorted(files):
            if not (fname.endswith(".json.gz") or fname.endswith(".json")):
                continue
            result = one_file(os.path.join(root, fname),
                              fname.endswith(".gz"))
            if result is not None:
                return result
    return None
