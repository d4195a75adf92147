#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``), the CUDA and
   PyTorch versions; TF32 is switched off for matrix products and
   convolutions, so every fp32 product is full fp32.
2. build: ``nvcc`` builds every kernel source of the port from ``csrc/``,
   one compiler per source, all at once.
3. kernels: each kernel against its plain PyTorch version on the same
   inputs, at the shapes the main path gives it (64 receivers, a 2 x 64
   ring, rows of 73,420 columns, the 10 CIFAR10Net leaves, K = 4 or one
   slot) and at ragged shapes (F not a multiple of 4; leaf edges inside a
   4-column word); ring rows (or int8 scales) behind empty slots are NaN
   or Inf where the kernel must not read them. For each: the max abs
   error, the device time of one call of the kernel and of the plain
   version (CUDA graph of 20 calls, replayed between CUDA events, median
   of 50), and the least time the card could take, with what bounds it.
4. paths: a 64-node CIFAR10Net gossip run on the card (clique, PUSH,
   MERGE_UPDATE, 4-slot mailbox, SGD 0.05, batch 32, synthetic 32x32x3
   data with 64 images per node), on each deliver path: the single-pass
   fused deliver with an fp32 ring (the first slice's main path: 5 timed
   rounds, then one profiled round and the host-clock time of each
   phase), then the plain deliver with compaction (auto), the per-slot
   fused deliver with fp32, bf16 and int8 rings and the single-pass one
   with bf16 and int8 rings (a warm-up round, 3 timed rounds and the
   phase times each). Launch counts are set to 0 just before each path's
   timed rounds and read just after: the multi-slot kernels launch once
   per round with messages, the single-slot ones once per occupied slot,
   and the plain path launches none.
5. reference: the same small run of each path on the CPU (plain versions)
   and on the card (kernels), from the same seeds: equal accounting, close
   params (within one encoding step more for the bf16 and int8 rings).

The last lines are the card's name and power limit, one JSON object with
every kernel's numbers, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

ROUNDS = 5          # timed rounds of the fp32 single-pass path
LEG_ROUNDS = 3      # timed rounds of each other path
N_NODES = 64
SLOTS = 4
KERNEL_TOL = 0.0    # --fmad=false: the kernels round as the plain versions
REF_TOL = 1e-4      # card vs CPU params: matmul reduction order differs

# Device memory rate of each H100 part (NVIDIA data sheets), by a
# substring of torch.cuda.get_device_name().
MEMORY_BYTES_PER_S = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                      ("H100", 3.35e12))
# fp32 outside the tensor cores, H100 SXM (NVIDIA's data sheet); the folds
# are elementwise, so no tensor-core rate applies.
FP32_FLOPS = 67e12

# The paths of phase 4 after the first: (label, fused_merge, history_dtype).
LEGS = (("plain", False, "float32"),
        ("per_slot", "per_slot", "float32"),
        ("per_slot-bf16", "per_slot", "bfloat16"),
        ("per_slot-int8", "per_slot", "int8"),
        ("multi-bf16", "multi", "bfloat16"),
        ("multi-int8", "multi", "int8"))
ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def memory_rate(name: str) -> float:
    for key, rate in MEMORY_BYTES_PER_S:
        if key in name:
            return rate
    raise RuntimeError(f"no memory rate known for {name!r}")


def time_ms(torch, fn, reps: int = 20, iters: int = 50) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph,
    replayed ``iters`` times between CUDA events; the median replay over
    ``reps``. The graph removes the host's launch overhead from the
    window, so this is the time the card spends on the call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def call_ms(torch, fn, iters: int = 50) -> float:
    """Median host-clock time of one eager call, launch overhead included
    (synchronised after each call)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(nbytes: int, flops: int, rate: float):
    """The least time for ``nbytes`` and ``flops``, and which bounds it."""
    bytes_ms, flops_ms = nbytes / rate * 1e3, flops / FP32_FLOPS * 1e3
    return (max(bytes_ms, flops_ms),
            "bytes" if bytes_ms >= flops_ms else "operations")


def merge_tables(rng, n: int, d: int, k: int):
    """Tables as one round of the main path builds them: each of ``n``
    senders picks one peer of a clique; slots fill in sender order; an
    empty slot is (ws, wp) = (1, 0) with an index into the older ring
    cell."""
    peers = (np.arange(n) + rng.integers(1, n, n)) % n
    idx = np.full((n, k), n, np.int64)  # empty: a row of the other cell
    wp = np.zeros((n, k), np.float32)
    fill = np.zeros(n, np.int64)
    for s, r in enumerate(peers):
        if fill[r] < k:
            idx[r, fill[r]] = s
            wp[r, fill[r]] = 0.5
            fill[r] += 1
    idx = np.where(wp == 0, n + rng.integers(0, (d - 1) * n, (n, k)), idx)
    return idx, (1.0 - wp).astype(np.float32), wp


def check_merge(torch, merge, n, d, f, k, seed, rate):
    """K1 against its plain version; times and bound at this shape."""
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    p = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(dev)
    h = rng.normal(size=(d * n, f)).astype(np.float32)
    h[n:] = np.nan          # only empty slots point past the first cell
    h[n::5] = np.inf
    h = torch.from_numpy(h).to(dev)
    idx, ws, wp = merge_tables(rng, n, d, k)
    idx_t = torch.from_numpy(idx).to(dev)
    ws_t = torch.from_numpy(ws).to(dev)
    wp_t = torch.from_numpy(wp).to(dev)
    args = (p, h, idx_t, ws_t, wp_t)
    got = merge.gather_merge_multi_cuda(*args)
    want = merge.gather_merge_multi_reference(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise RuntimeError("K1 output is not finite (NaN rows leaked)")
    err = float((got - want).abs().max())
    if err > KERNEL_TOL:
        raise RuntimeError(f"K1 disagrees with its plain version: max abs "
                           f"err {err} > {KERNEL_TOL} at {(n, d * n, f, k)}")
    # Least work: p read once, out written once, each live ring row read
    # once, the [N, K] tables read once; per element a live slot costs a
    # multiply, a multiply and an add, an empty one a multiply and an add.
    live = int((wp != 0).sum())
    live_rows = len(np.unique(idx[wp != 0]))
    nbytes = 4 * f * (2 * n + live_rows) + n * k * (8 + 4 + 4)
    flops = f * (3 * live + 2 * (n * k - live))
    ms = time_ms(torch, lambda: merge.gather_merge_multi_cuda(*args))
    plain_ms = time_ms(torch,
                       lambda: merge.gather_merge_multi_reference(*args))
    eager_ms = call_ms(torch, lambda: merge.gather_merge_multi_cuda(*args))
    bound_ms, bound_by = bound(nbytes, flops, rate)
    log(f"[kernels] gather_merge_multi n={n} m={d * n} f={f} k={k} "
        f"live_slots={live} max_abs_err={err} ms={ms:.5f} "
        f"plain_ms={plain_ms:.5f} bound_ms={bound_ms:.5f} "
        f"eager_call_ms={eager_ms:.5f} ({nbytes} bytes, {flops} flops, "
        f"bound by {bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def wire_ring(torch, rng, m, f, n_leaves, wire, dev):
    """A ``[m, f]`` ring in ``wire`` format and, for int8, its ``[m, L]``
    scales (else None), on ``dev``."""
    if wire == "int8":
        q = rng.integers(-127, 128, (m, f)).astype(np.int8)
        scale = rng.uniform(0.001, 0.02, (m, n_leaves)).astype(np.float32)
        return torch.from_numpy(q).to(dev), scale
    h = torch.from_numpy(rng.normal(size=(m, f)).astype(np.float32))
    return h.to(dev, getattr(torch, wire)), None


def check_wire_kernel(torch, merge, slots, wire, n, d, f, k, starts, seed,
                      rate):
    """K2 (``slots="multi"``), K3 or K4 (``slots="single"``) against its
    plain version; times and bound at this shape. For K2 every ring row
    (bfloat16) or scale (int8) that only empty slots name is NaN or Inf."""
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    m = d * n
    p = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(dev)
    h, scale = wire_ring(torch, rng, m, f, len(starts), wire, dev)
    idx, ws, wp = merge_tables(rng, n, d, k)
    if slots == "multi":
        if scale is not None:
            scale[n:] = np.nan
            scale[n::5] = np.inf
        else:
            h[n:] = float("nan")
            h[n::5] = float("inf")
    else:
        idx, ws, wp = idx[:, :1], ws[:, :1], wp[:, :1]
    scale_t = None if scale is None else torch.from_numpy(scale).to(dev)
    starts_t = None if scale is None else torch.tensor(
        starts, dtype=torch.int32, device=dev)
    tabs = [torch.from_numpy(a).to(dev) for a in (idx, ws, wp)]
    if slots == "multi":
        name = merge.KERNEL_MULTI_DQ
        args = (p, h, *tabs)

        def kernel():
            return merge.gather_merge_multi_dq_cuda(*args, scale_t, starts_t)

        def plain():
            return merge.gather_merge_multi_reference(*args, scale_t,
                                                      starts_t)
    else:
        name = merge.KERNEL_FLAT_DQ if (wire != "float32") \
            else merge.KERNEL_FLAT
        args = (p, h, *(t[:, 0] for t in tabs))

        def kernel():
            return merge.gather_merge_flat_cuda(*args, scale_t, starts_t)

        def plain():
            return merge.gather_merge_reference(*args, scale_t, starts_t)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{name} [{wire}] output is not finite")
    err = float((got - want).abs().max())
    shape = (n, m, f, k, len(starts))
    if err > KERNEL_TOL:
        raise RuntimeError(f"{name} [{wire}] disagrees with its plain "
                           f"version: max abs err {err} > {KERNEL_TOL} at "
                           f"{shape}")
    # Least work: p read once, out written once, each ring row the
    # function reads once at wire width (the live ones for K2; every
    # receiver's for K3/K4, which have no zero-weight mask) with its L
    # scales, the tables and leaf starts once. Per element: a live slot is
    # a multiply (the scale, int8 only), a multiply and the blend's
    # multiply and add; an empty slot of K2 the blend's multiply and add.
    isz = ITEMSIZE[wire]
    n_scales = 0 if scale is None else len(starts)
    live = int((wp != 0).sum())
    if slots == "multi":
        rows = len(np.unique(idx[wp != 0]))
        reads = live
        flops = f * (3 * live + 2 * (n * k - live))
    else:
        rows = len(np.unique(idx))
        reads = n
        flops = f * 3 * n
    if scale is not None:
        flops += f * reads
    nbytes = (4 * f * 2 * n + isz * f * rows + n * k * (8 + 4 + 4)
              + 4 * n_scales * rows + 4 * n_scales)
    ms = time_ms(torch, kernel)
    plain_ms = time_ms(torch, plain)
    bound_ms, bound_by = bound(nbytes, flops, rate)
    log(f"[kernels] {name} [{wire}] n={n} m={m} f={f} k={k} "
        f"leaves={len(starts)} live_slots={live} max_abs_err={err} "
        f"ms={ms:.5f} plain_ms={plain_ms:.5f} bound_ms={bound_ms:.5f} "
        f"({nbytes} bytes, {flops} flops, bound by {bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def cifar_sim(torch, n: int, per_node: int, batch: int, device, eval_every,
              seed: int = 0, fused_merge="multi", history_dtype="float32",
              compact_deliver=None):
    from gossipy_tpu_torch.core import AntiEntropyProtocol, Topology
    from gossipy_tpu_torch.data import (ClassificationDataHandler,
                                        DataDispatcher)
    from gossipy_tpu_torch.handlers import SGDHandler, losses
    from gossipy_tpu_torch.models import CIFAR10Net
    from gossipy_tpu_torch.random import TorchDraws
    from gossipy_tpu_torch.simulation import GossipSimulator

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n * per_node, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, n * per_node)
    disp = DataDispatcher(ClassificationDataHandler(X, y, test_size=0.2),
                          n=n, eval_on_user=False)
    handler = SGDHandler(CIFAR10Net(), losses.cross_entropy,
                         learning_rate=0.05, local_epochs=1,
                         batch_size=batch, n_classes=10,
                         input_shape=(32, 32, 3))
    sim = GossipSimulator(handler, Topology.clique(n), disp.stacked(),
                          delta=100, protocol=AntiEntropyProtocol.PUSH,
                          eval_every=eval_every, fused_merge=fused_merge,
                          compact_deliver=compact_deliver,
                          history_dtype=history_dtype,
                          mailbox_slots=SLOTS, draws=TorchDraws(seed),
                          device=device)
    state = sim.init_nodes(torch.Generator().manual_seed(seed),
                           common_init=True)
    return sim, state


def profile_round(torch, sim, state) -> None:
    """One main-path round (no eval) under torch.profiler: the kernels
    that take the card's time, in order, and the card's idle share of the
    round's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim._round(state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return getattr(e, attr)
        return 0.0
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy = sum(dev_us(e) for e in kernels)
    if busy <= 0:
        log("[profile] the profiler recorded no device time")
        return
    log(f"[profile] one round without eval: wall {wall_us / 1e3:.3f} ms, "
        f"device busy {busy / 1e3:.3f} ms, idle share "
        f"{1 - busy / wall_us:.3f}")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        log(f"[profile]   {dev_us(e) / 1e3:8.3f} ms {e.count:5d}x "
            f"{e.key[:90]}")


def phase_times(torch, sim, state, label: str, rounds: int = 3) -> None:
    """Host-clock ms of each phase of a round, synchronised around each
    phase, averaged over ``rounds`` rounds (eval every round here, where
    the timed runs evaluate once per run)."""
    tot = {"snapshot": 0.0, "send": 0.0, "deliver": 0.0, "eval": 0.0}
    for _ in range(rounds):
        r = state.round
        steps = (("snapshot", lambda: sim._snapshot(state, r)),
                 ("send", lambda: sim._send_phase(state, r)),
                 ("deliver", lambda: sim._deliver_phase(state, r)),
                 ("eval", lambda: sim._eval_phase(state)))
        for name, fn in steps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            tot[name] += (time.perf_counter() - t0) * 1e3
        state.round = r + 1
    log(f"[phases] {label}: ms per round: " + ", ".join(
        f"{k} {v / rounds:.3f}" for k, v in tot.items()))


def check_path_output(torch, sim, state, rep, label: str) -> None:
    stride = sim.handler.layout.stride
    acc = rep.final("accuracy")
    if not torch.isfinite(state.model.params).all():
        raise RuntimeError(f"{label}: non-finite params")
    if state.model.params.shape != (N_NODES, stride) or not np.isfinite(acc):
        raise RuntimeError(f"{label}: output has the wrong shape or a "
                           "non-finite accuracy")


def run_leg(torch, merge, label: str, fused, wire: str) -> dict:
    """One path of phase 4 after the first: a warm-up round, LEG_ROUNDS
    timed rounds with the launch counts checked against the path, the
    phase times. Returns the launches per kernel of the timed rounds."""
    sim, state = cifar_sim(torch, N_NODES, 64, 32, "cuda", LEG_ROUNDS + 1,
                           fused_merge=fused, history_dtype=wire)
    state, _ = sim.start(state, n_rounds=1)     # warm-up round
    torch.cuda.synchronize()
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    state, rep = sim.start(state, n_rounds=LEG_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in merge.LAUNCHES.items() if v}
    compact, wide = rep.compact_slots_per_round, rep.wide_slots_per_round
    occupied = int((compact + wide).sum())
    with_msgs = int(((compact + wide) > 0).sum())
    log(f"[path] {label}: {N_NODES}-node CIFAR10Net, fused_merge={fused!r}, "
        f"history_dtype={wire}, compaction cap {sim._compact_cap}, "
        f"{LEG_ROUNDS} rounds: {wall / LEG_ROUNDS * 1e3:.3f} ms/round; sent "
        f"{rep.sent_per_round.tolist()} failed {rep.failed_per_round.tolist()}"
        f"; compact_slots {compact.tolist()} wide_slots {wide.tolist()}; "
        f"launches {launches}; final global accuracy "
        f"{rep.final('accuracy')}")
    if fused is False:
        want = {}
        if sim._compact_cap is None or int(compact.sum()) == 0:
            raise RuntimeError(f"{label}: compaction did not run")
    elif fused == "per_slot":
        kernel = merge.KERNEL_FLAT if wire == "float32" \
            else merge.KERNEL_FLAT_DQ
        want = {kernel: occupied}
    else:
        want = {merge.KERNEL_MULTI_DQ: with_msgs}
    if launches != want or (fused and occupied == 0):
        raise RuntimeError(f"{label}: launches {launches}, the path must "
                           f"make {want}")
    check_path_output(torch, sim, state, rep, label)
    phase_times(torch, sim, state, label)
    return launches


def card_vs_cpu(torch, merge, label: str, fused, wire: str) -> None:
    """The same 8-node, 3-round run on the CPU and on the card: equal
    accounting and launch counts as the path needs, params within
    REF_TOL plus one encoding step of the ring (half a bf16 step of the
    value, or half an int8 quantum of the leaf, after the 0.5 blend)."""
    runs = {}
    # The plain path takes an explicit capacity here (auto compaction
    # needs N >= 48), so the compacted pass runs in the comparison too.
    compact = 3 if fused is False else None
    for dev in ("cpu", "cuda"):
        merge.reset_launch_counts()
        s_sim, s_state = cifar_sim(torch, 8, 8, 4, dev, 3, seed=7,
                                   fused_merge=fused, history_dtype=wire,
                                   compact_deliver=compact)
        s_state, s_rep = s_sim.start(s_state, n_rounds=3)
        runs[dev] = (s_sim, s_state, s_rep, sum(merge.LAUNCHES.values()))
    (sim, st_c, r_c, l_c), (_, st_g, r_g, l_g) = runs["cpu"], runs["cuda"]
    for field in ("sent_per_round", "failed_per_round",
                  "compact_slots_per_round", "wide_slots_per_round"):
        if not np.array_equal(getattr(r_c, field), getattr(r_g, field)):
            raise RuntimeError(f"{label}: card and CPU runs differ in "
                               f"{field}")
    p_c, p_g = st_c.model.params, st_g.model.params.cpu()
    tol = torch.full_like(p_c, REF_TOL)
    if wire == "bfloat16":
        tol = tol + 2.0 ** -8 * p_c.abs()
    elif wire == "int8":
        quantum = 0.5 * st_c.history_scale.amax(dim=(0, 1))
        tol = tol + quantum[sim._col_leaf.cpu()]
    diff = (p_c - p_g).abs()
    worst = float((diff - tol).max())
    log(f"[reference] {label}: 8-node CIFAR10Net, 3 rounds, card vs CPU: max "
        f"abs param diff {float(diff.max()):.3e}, worst margin to the "
        f"tolerance {worst:.3e} (<= 0 passes); launches card {l_g}, CPU "
        f"{l_c}; slots {(r_g.compact_slots_per_round + r_g.wide_slots_per_round).tolist()}")
    if worst > 0 or l_c != 0 or (l_g == 0) != (fused is False):
        raise RuntimeError(f"{label}: card run does not agree with the CPU "
                           "run")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from gossipy_tpu_torch.ops import _build, merge

    # 1. device
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}; TF32 off for matmul and "
        "cudnn (fp32 products in full fp32)")
    rate = memory_rate(name)
    log(f"[device] memory rate for the bound: {rate / 1e12} TB/s ({name})")

    # 2. build
    sources = sorted(set(merge.SOURCES.values()))
    t0 = time.perf_counter()
    _build.build(sources)
    log(f"[build] {', '.join(sources)} built in "
        f"{time.perf_counter() - t0:.1f} s")
    for src in sources:
        for line in _build.build_log(src).splitlines():
            if "registers" in line or "spill" in line or \
                    "Compiling entry" in line:
                log(f"[build]   {src}: {line.strip()}")

    # 3. kernels against their plain versions
    from gossipy_tpu_torch.handlers import SGDHandler, losses
    from gossipy_tpu_torch.models import CIFAR10Net
    layout = SGDHandler(CIFAR10Net(), losses.cross_entropy,
                        input_shape=(32, 32, 3)).layout
    stride = layout.stride
    starts = [layout.offsets[leaf] for leaf, _ in layout.leaves]
    k1 = check_merge(torch, merge, N_NODES, 2, stride, SLOTS, 1, rate)
    check_merge(torch, merge, N_NODES, 2, stride - 2, SLOTS, 2, rate)
    check_merge(torch, merge, 5, 2, 37, 3, 3, rate)
    # Ragged shapes: F = 37 (the scalar form) and F = 44 with leaf edges at
    # columns 5, 6, 13 and 30, inside 4-column words (the vector form).
    ragged = ((5, 37, [0, 5, 6, 17]), (6, 44, [0, 5, 6, 13, 30]))
    numbers = {}
    for slots, wire in (("multi", "bfloat16"), ("multi", "int8"),
                        ("single", "float32"), ("single", "bfloat16"),
                        ("single", "int8")):
        k = SLOTS if slots == "multi" else 1
        numbers[(slots, wire)] = check_wire_kernel(
            torch, merge, slots, wire, N_NODES, 2, stride, k, starts, 11,
            rate)
        for seed, (n, f, st) in enumerate(ragged, start=12):
            check_wire_kernel(torch, merge, slots, wire, n, 2, f, 3 if k > 1
                              else 1, st, seed, rate)

    # 4. the paths: first the fp32 single-pass fused deliver
    sim, state = cifar_sim(torch, N_NODES, 64, 32, "cuda", ROUNDS + 1)
    state, _ = sim.start(state, n_rounds=1)     # warm-up round
    torch.cuda.synchronize()
    merge.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, rep = sim.start(state, n_rounds=ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = merge.LAUNCHES[merge.KERNEL]
    others = sum(merge.LAUNCHES.values()) - launches
    rounds_with_msgs = int((rep.wide_slots_per_round > 0).sum())
    log(f"[main] {N_NODES}-node CIFAR10Net, {ROUNDS} rounds: "
        f"{wall / ROUNDS * 1e3:.3f} ms/round; sent "
        f"{rep.sent_per_round.tolist()} failed {rep.failed_per_round.tolist()}"
        f"; final global accuracy {rep.final('accuracy')}; K1 launches "
        f"{launches} for {rounds_with_msgs} rounds with messages; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches != rounds_with_msgs or launches == 0 or others:
        raise RuntimeError(f"K1 launched {launches} times for "
                           f"{rounds_with_msgs} rounds with messages "
                           f"({others} other launches)")
    check_path_output(torch, sim, state, rep, "multi")

    # Where a round's time goes (after the checks: it runs more rounds).
    profile_round(torch, sim, state)
    phase_times(torch, sim, state, "multi")
    del sim, state

    leg_launches = {}
    for label, fused, wire in LEGS:
        leg_launches[label] = run_leg(torch, merge, label, fused, wire)
        torch.cuda.empty_cache()

    # 5. the card against the CPU on a small run from the same seeds
    card_vs_cpu(torch, merge, "multi", "multi", "float32")
    for label, fused, wire in LEGS:
        card_vs_cpu(torch, merge, label, fused, wire)

    def entry(kernel, wire, source, replaces, nums, launched):
        return {"name": kernel if wire is None else f"{kernel}[{wire}]",
                "route": "cuda", "source": f"gossipy_tpu_torch/csrc/{source}",
                "replaces": f"gossipy_tpu/ops/merge.py:{replaces}",
                "launches": launched, "max_abs_err": nums["max_abs_err"],
                "ms": nums["ms"], "plain_ms": nums["plain_ms"],
                "bound_ms": nums["bound_ms"], "bound_by": nums["bound_by"],
                "library_ms": None}

    kernels = [entry(merge.KERNEL, None, "gather_merge_multi.cu", 76, k1,
                     launches)]
    for slots, wire, label, kernel, source, line in (
            ("multi", "bfloat16", "multi-bf16", merge.KERNEL_MULTI_DQ,
             "gather_merge_multi.cu", 100),
            ("multi", "int8", "multi-int8", merge.KERNEL_MULTI_DQ,
             "gather_merge_multi.cu", 100),
            ("single", "float32", "per_slot", merge.KERNEL_FLAT,
             "gather_merge_flat.cu", 60),
            ("single", "bfloat16", "per_slot-bf16", merge.KERNEL_FLAT_DQ,
             "gather_merge_flat.cu", 65),
            ("single", "int8", "per_slot-int8", merge.KERNEL_FLAT_DQ,
             "gather_merge_flat.cu", 65)):
        kernels.append(entry(kernel, None if wire == "float32" else wire,
                             source, line, numbers[(slots, wire)],
                             leg_launches[label][kernel]))
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
