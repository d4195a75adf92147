#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``), the CUDA and
   PyTorch versions; TF32 is switched off for matrix products and
   convolutions, so every fp32 product is full fp32.
2. build: ``nvcc`` builds every kernel of the port from ``csrc/``.
3. kernels: each kernel against its plain PyTorch version on the same
   inputs, at the shapes the main path gives it and at ragged shapes;
   the device time of one call of the kernel and of the plain version
   (CUDA graph of 20 calls, replayed between CUDA events, median of 50),
   and the least time the card could take.
4. main path: a 64-node CIFAR10Net gossip run on the card (clique, PUSH,
   MERGE_UPDATE, 4-slot mailbox, single-pass fused deliver, SGD 0.05,
   batch 32, synthetic 32x32x3 data with 64 images per node), launch
   counts set to 0 just before the timed rounds and read just after;
   then one more round under torch.profiler (device time by kernel, idle
   share) and the host-clock time of each phase.
5. reference: the same small run on the CPU (plain versions) and on the
   card (kernels), from the same seeds: equal accounting, close params.

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

ROUNDS = 5          # timed rounds of the main path
N_NODES = 64
SLOTS = 4
KERNEL_TOL = 0.0    # --fmad=false: the kernel rounds as the plain version
REF_TOL = 1e-4      # card vs CPU params: matmul reduction order differs

# Device memory rate of each H100 part (NVIDIA data sheets), by a
# substring of torch.cuda.get_device_name().
MEMORY_BYTES_PER_S = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                      ("H100", 3.35e12))
# fp32 outside the tensor cores, H100 SXM (NVIDIA's data sheet); the fold
# is elementwise, so no tensor-core rate applies.
FP32_FLOPS = 67e12


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
    bytes_ms, flops_ms = nbytes / rate * 1e3, flops / FP32_FLOPS * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    bound_by = "bytes" if bytes_ms >= flops_ms else "operations"
    log(f"[kernels] gather_merge_multi n={n} m={d * n} f={f} k={k} "
        f"live_slots={live} max_abs_err={err} ms={ms:.5f} "
        f"plain_ms={plain_ms:.5f} bound_ms={bound_ms:.5f} "
        f"eager_call_ms={eager_ms:.5f} ({nbytes} bytes, {flops} flops, "
        f"bound by {bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def cifar_sim(torch, n: int, per_node: int, batch: int, device, eval_every,
              seed: int = 0):
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
                          eval_every=eval_every, fused_merge="multi",
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


def phase_times(torch, sim, state, rounds: int = 3) -> None:
    """Host-clock ms of each phase of a main-path round, synchronised
    around each phase, averaged over ``rounds`` rounds (eval every round
    here, where the main path evaluates once per run)."""
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
    log("[phases] ms per round: " + ", ".join(
        f"{k} {v / rounds:.3f}" for k, v in tot.items()))


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
    t0 = time.perf_counter()
    _build.build([merge.KERNEL])
    log(f"[build] {merge.KERNEL} built in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log(merge.KERNEL).splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")

    # 3. kernels against their plain versions
    from gossipy_tpu_torch.handlers import SGDHandler, losses
    from gossipy_tpu_torch.models import CIFAR10Net
    stride = SGDHandler(CIFAR10Net(), losses.cross_entropy,
                        input_shape=(32, 32, 3)).layout.stride
    k1 = check_merge(torch, merge, N_NODES, 2, stride, SLOTS, 1, rate)
    check_merge(torch, merge, N_NODES, 2, stride - 2, SLOTS, 2, rate)
    check_merge(torch, merge, 5, 2, 37, 3, 3, rate)

    # 4. the main path
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
    rounds_with_msgs = int((rep.wide_slots_per_round > 0).sum())
    acc = rep.final("accuracy")
    log(f"[main] {N_NODES}-node CIFAR10Net, {ROUNDS} rounds: "
        f"{wall / ROUNDS * 1e3:.3f} ms/round; sent "
        f"{rep.sent_per_round.tolist()} failed {rep.failed_per_round.tolist()}"
        f"; final global accuracy {acc}; K1 launches {launches} for "
        f"{rounds_with_msgs} rounds with messages; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches != rounds_with_msgs or launches == 0:
        raise RuntimeError(f"K1 launched {launches} times for "
                           f"{rounds_with_msgs} rounds with messages")
    if not torch.isfinite(state.model.params).all():
        raise RuntimeError("non-finite params after the main path")
    if state.model.params.shape != (N_NODES, stride) or not np.isfinite(acc):
        raise RuntimeError("main path output has the wrong shape or a "
                           "non-finite accuracy")

    # Where a round's time goes (after the checks: it runs more rounds).
    profile_round(torch, sim, state)
    phase_times(torch, sim, state)

    # 5. the card against the CPU on a small run from the same seeds
    runs = {}
    for dev in ("cpu", "cuda"):
        merge.reset_launch_counts()
        s_sim, s_state = cifar_sim(torch, 8, 8, 4, dev, 3, seed=7)
        s_state, s_rep = s_sim.start(s_state, n_rounds=3)
        runs[dev] = (s_state.model.params.cpu(), s_rep,
                     merge.LAUNCHES[merge.KERNEL])
    (p_cpu, r_cpu, l_cpu), (p_gpu, r_gpu, l_gpu) = runs["cpu"], runs["cuda"]
    for field in ("sent_per_round", "failed_per_round",
                  "wide_slots_per_round"):
        if not np.array_equal(getattr(r_cpu, field), getattr(r_gpu, field)):
            raise RuntimeError(f"card and CPU runs differ in {field}")
    ref_err = float((p_cpu - p_gpu).abs().max())
    log(f"[reference] 8-node CIFAR10Net, 3 rounds, card vs CPU: max abs "
        f"param diff {ref_err:.3e} (tolerance {REF_TOL}); K1 launches "
        f"card {l_gpu}, CPU {l_cpu}")
    if ref_err > REF_TOL or l_cpu != 0 or l_gpu == 0:
        raise RuntimeError("card run does not agree with the CPU run")

    log(smi)
    print(json.dumps({"kernels": [{
        "name": merge.KERNEL, "route": "cuda",
        "source": "gossipy_tpu_torch/csrc/gather_merge_multi.cu",
        "replaces": "gossipy_tpu/ops/merge.py:76",
        "launches": launches, "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
