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
   fused deliver with an fp32 ring (the first slice's main path: 3 timed
   rounds, then one profiled round and the host-clock time of each
   phase), then the plain deliver with compaction (auto), the per-slot
   fused deliver with fp32, bf16 and int8 rings and the single-pass one
   with bf16 and int8 rings (a warm-up round, 2 timed rounds and the
   phase times each). Launch counts are set to 0 just before each path's
   timed rounds and read just after: the multi-slot kernels launch once
   per round with messages, the single-slot ones once per occupied slot,
   and the plain path launches none.
5. reference: the same small run of each path on the CPU (plain versions)
   and on the card (kernels), from the same seeds: equal accounting, close
   params (within one encoding step more for the bf16 and int8 rings).
6. attention: the flash-attention hop kernel K5 in its three routes,
   built in phase 2: bf16 operands run ``csrc/flash_hop_sm90.cu`` (tensor
   cores, TMA, a balanced causal work list), f32 ones with D, Dv <= 128
   ``csrc/flash_hop_tf32.cu`` (the same machinery as 3xTF32, after its
   split pre-pass), f32 ones with D or Dv in 129..256 the same source's
   wider instances (the same kernel on 64-row query tiles). The pre-pass
   bit for bit against its plain version (edge values: rounding ties,
   zeros, subnormals; up to 8 groups of 32 columns; the timed shapes)
   and its time; K5 against its plain version at the JAX bench's
   regime (S = 8192, one head, D = 128, causal, bf16 and f32), on
   mid-stream hops (a random carry; a chunk wholly in the past, one
   across the diagonal), at ragged shapes (1000 x 777 rows, D = 72), with
   wholly masked rows whose m is _NEG (f32, bf16, wide f32), on hops whose
   query tiles are cut into many pieces merged in the launch (bf16, wide
   f32), on asymmetric wide heads (D 64 with Dv 180, D 200 with Dv 40)
   and on every instance of each route; a CUDA graph of one hop (wide
   f32, bf16) replayed after 70 hops of other shapes and compared with
   an eager call, so that a work list a graph keeps is never freed; then
   the bf16 route's main run: ``flash_attention`` at the bench shape
   with its launches counted, its device time beside the plain version,
   ``scaled_dot_product_attention`` (SDPA) and the bound; the 3xTF32
   route's output at the training shape (S = 8192, D = 128, non-causal)
   against its plain version's and its time there and at the causal bench
   shape beside the plain version, SDPA in f32 (its
   kernel named) and the bounds at the TF32 and the f32 rates; the wide
   f32 route's run (3 ``flash_attention`` calls at S = 2048, D = 256,
   launches of the hop and of its pre-pass counted, the output against
   the plain version's) and its time;
   ``flash_attention``'s forward and gradient against dense attention
   through autograd (the JAX bench's ``_attention_parity`` rule); and the
   training demo (``gossipy_tpu_torch.examples.demo_ring_attention``,
   f32), at its defaults with K5's launches counted (one 3xTF32 hop and
   one pre-pass per step, none from the backward), then 3 steps at
   S = 8192, D = 128 with K5 and with the plain version, whose losses
   must agree. ``attention_diagnostics`` (not run here) breaks K5's time
   down further.
7. north star: the configuration of ``bench.py::build_sim``, built through
   the port's entry points (``Topology.random_regular(100, 20, seed=42)``,
   ``load_classification_dataset("spambase")``, the data handler and
   dispatcher, ``SGDHandler`` over ``LogisticRegression(57, 2)``, SGD 0.1,
   batch 32, MERGE_UPDATE, PUSH, a global eval every round), on its two
   legs: the default deliver (``fused_merge=False``, compaction on by
   itself at N = 100) and the single-pass one (K1). (a) 10 rounds on the
   card and on the CPU from the same seeds: equal accounting (sent,
   failures by cause, mailbox high-water mark, compact/wide slots, both
   boxes), params within REF_TOL. K1, K2 and K3 against their plain
   versions, timed, at the shapes the north star gives them (100 rows of
   LogReg's 116-column stride, the derived 6 slots or one, a two-cell
   ring). (b) Each leg timed: a warm-up, then
   BENCH_ROUNDS rounds from the same initial state and the same draws,
   the card synchronised before the host clock stops; rounds/s, final
   global accuracy, the kernels' launches (counts set to 0 just before),
   one profiled round's idle share. (c) The paper examples' network model
   (``UniformDelay(0, 10)``, 10% drops, 20% online, ``sampling_eval=0.1``)
   in 10-round card-against-CPU runs: on the single-pass deliver with a
   bf16 ring (K2), with PUSH_PULL on the single-pass deliver (K1 in the
   reply phase) and on the per-slot one (K3), and with async nodes. On
   the card every merge call of these runs is held, as it happens,
   against its plain version on the same tables (ring cells older than
   the round's own, the reply box's tables), and each run must launch
   its kernels.

8. flagship: the 100-node CIFAR-10 configuration of
   ``examples/main_cifar10_100nodes.py`` (and
   ``examples/configs/cifar10_100nodes.json``), built by its twin
   ``gossipy_tpu_torch.examples.main_cifar10_100nodes``: the synthetic
   CIFAR-10 stand-in normalised by the training statistics,
   ``label_dirichlet_skew(0.5)``, CIFAR10Net under weight decay 1e-3 and
   SGD 0.05, batch 32, MERGE_UPDATE, PUSH on ``random_regular(100, 20,
   seed=42)``, a 10% sampled eval every round, common init, the
   single-pass deliver. (a) 16 nodes, 2048 images, 3 rounds on the card
   and on the CPU from the same seeds, fp32 compute with an fp32 ring,
   then bf16 compute with fp32, bf16 and int8 rings: accounting, boxes
   and ages equal, params by the rule of PERF.md §2 (a ReLU or max-pool
   decision near a tie may flip between the two: the fp32 run's median
   element within REF_TOL and its largest within what bf16 compute moves
   the run; a bf16 run within twice that), and every K1 and
   K2 call of the card runs held bit-equal to its plain version as it
   happens (``MergeAudit``). K1 and K2 (bf16, int8) against their plain
   versions, timed, at the flagship's shape (100 rows of CIFAR10Net's
   stride, the derived K, a two-cell ring). (b) The full width: 100
   nodes, all 50,000 training images split by the Dirichlet skew, 10,000
   test images, bf16 compute, on three ring legs (fp32: K1; bf16, int8:
   K2): a warm-up round, FLAG_ROUNDS timed rounds with the card
   synchronised before the host clock stops, the launches (counts set to
   0 just before; one per round with messages), the final sampled
   accuracy, ``memory_budget()`` beside ``max_memory_allocated``, one
   profiled round's idle share and the phase times.

9. papers: the four paper examples on the vanilla simulator, built by
   their twins (``gossipy_tpu_torch/examples/main_ormandi_2013.py``,
   ``main_berta_2014.py``, ``main_hegedus_2020.py``,
   ``main_danner_2023.py``): Ormandi (Pegasos over AdaLine, one node per
   training sample, a clique, async PUSH, ``UniformDelay(0, 10)``, 20%
   online, 10% drops, the single-pass deliver: K1), Berta (k-means with
   Hungarian matching, one node per sample, sync PUSH, ``delta=1000``),
   Hegedus (MF on the ml-100k stand-in, one user a node,
   ``random_regular(943, 20)``) and Danner (limited merging of LogReg
   under weight decay and SGD 1.0, 100 nodes); the last three take the
   plain path. (a) Each at a cut size (64 nodes; Hegedus 64 users;
   Danner 16) for PAPER_CHECK_ROUNDS rounds on the card and on the CPU
   from the same seeds: accounting, boxes and ages equal, params within
   REF_TOL plus REF_TOL of their magnitude, every K1 call of the Ormandi
   run bit-equal to its plain version (``MergeAudit``), no launch on the
   plain path. K1 against its plain version, timed, at the Ormandi shape
   (4,141 rows of the 60-column stride, the derived K, the ring's 3
   cells). (b) Each at full width (4,141 nodes, 4,601, 943 users, 100)
   for PAPER_ROUNDS rounds: ms/round, the final metric (accuracy, NMI,
   local RMSE, accuracy), K1's launches against the rounds with messages,
   one profiled round's idle share, the phase times, and
   ``memory_budget()`` beside ``max_memory_allocated``.

10. variants: the node-behaviour, token-account and all-to-all
   simulators through the twins of the four paper examples they carry
   (``gossipy_tpu_torch/examples/main_giaretta_2019.py``,
   ``main_hegedus_2021.py``, ``main_onoszko_2021.py``,
   ``main_all2all.py``), and the token simulator over the north star:
   Giaretta 2019 (Pegasos on ``barabasi_albert(n, 10)``, async PUSH) in
   its three node behaviours (vanilla on the single-pass deliver: K1;
   pass-through and neighbour cache on the plain path), Hegedus 2021
   (100 LogReg nodes under UPDATE; the partitioned exchange under token
   accounts and the sampled one), All2All under uniform and
   Metropolis-Hastings mixing (one ``W_eff @ P`` a round), Onoszko 2021
   (PENS over 5 CIFAR10Net nodes), and ``TokenizedGossipSimulator`` on
   the per-slot fused deliver with an fp32 ring (K3) and a bf16 ring
   (K4). (a) Each at a cut size (64 nodes; 32; 3 nodes and 96 images for
   Onoszko; the north star's 100) for VARIANT_CHECK_ROUNDS rounds on the
   card and on the CPU from the same seeds, with token accounts under
   which nodes send from the first rounds: accounting, both boxes, ages,
   the ring's ages and ``aux`` equal; params within REF_TOL plus
   REF_TOL of their magnitude (Onoszko by the decision-flip rule);
   launches as the path makes them (K1 once a round with messages on
   Giaretta vanilla, K3 or K4 once per occupied slot on the token runs,
   none elsewhere), every call bit-equal to its plain version
   (``MergeAudit``). K1 against its plain version, timed, at Giaretta's
   shape (4,141 rows of the 60-column stride, K = 59), K3 and K4 (bf16)
   at the token north star's (100 rows of 116 columns, one slot). (b)
   Each at full width (4,141 nodes; 100; 5 nodes
   and 50,000 images) for VARIANT_ROUNDS rounds (Onoszko: a window of
   ONOSZKO_ROUNDS rounds holding a phase-1 merge and 2 phase-2 rounds,
   and its ms per local step): ms/round, the final sampled accuracy, the
   launches, one profiled round's idle share (Onoszko: of 30 local
   steps), the phase times, ``memory_budget()`` beside
   ``max_memory_allocated``.

The last lines are the card's name and power limit, one JSON object with
every kernel's numbers, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

ROUNDS = 3          # timed rounds of the fp32 single-pass path
LEG_ROUNDS = 2      # timed rounds of each other path
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
# Dense bf16 tensor-core rate of each H100 part (NVIDIA data sheets), the
# bound of attention's two products: a bf16 x bf16 product is exact in f32.
TENSOR_FLOPS = (("H100 PCIe", 756e12), ("H100 NVL", 835e12),
                ("H100", 989e12))
# The TF32 tensor-core rate is half the bf16 one on every H100 part (the
# same data sheets): the bound of the 3xTF32 route's three products.
TF32_PER_BF16 = 0.5
# The north-star configuration (bench.py:29-35, 228-260).
NS_NODES = 100
NS_DEGREE = 20
NS_CHECK_ROUNDS = 10
NS_WARMUP_ROUNDS = 20
# Timed rounds of each north-star leg: bench.py times 2000; 500 keep the
# whole script within half its time limit beside phase 8.
BENCH_ROUNDS = 500
ATTN_S = 8192       # the JAX bench's flash-attention regime:
ATTN_D = 128        # one head, head dim 128, causal (bench.py:1093)
# The flagship (examples/main_cifar10_100nodes.py,
# examples/configs/cifar10_100nodes.json) through its twin,
# gossipy_tpu_torch/examples/main_cifar10_100nodes.py.
FLAG_NODES = 100
FLAG_ROUNDS = 10            # timed rounds of each ring leg
FLAG_CHECK_NODES = 16       # the card-against-CPU runs
FLAG_CHECK_SUBSAMPLE = 2048
FLAG_CHECK_ROUNDS = 3
FLAG_WIRES = ("float32", "bfloat16", "int8")

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


def profile(torch, fn, label: str):
    """``fn`` once under torch.profiler: the kernels that take the card's
    time, in order, and the card's idle share of the call's wall time,
    which it returns (None when the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
        return None
    log(f"[profile] {label}: wall {wall_us / 1e3:.3f} ms, "
        f"device busy {busy / 1e3:.3f} ms, idle share "
        f"{1 - busy / wall_us:.3f}")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        log(f"[profile]   {dev_us(e) / 1e3:8.3f} ms {e.count:5d}x "
            f"{e.key[:90]}")
    return 1 - busy / wall_us


def phase_times(torch, sim, state, label: str, rounds: int = 3) -> None:
    """Host-clock ms of each phase of a round, synchronised around each
    phase, averaged over ``rounds`` rounds (eval every round here, where
    the timed runs evaluate once per run)."""
    tot = {"pre_send": 0.0, "snapshot": 0.0, "send": 0.0, "deliver": 0.0,
           "reply": 0.0, "eval": 0.0}
    for _ in range(rounds):
        r = state.round
        steps = (("pre_send", lambda: sim._pre_send(state, r)),
                 ("snapshot", lambda: sim._snapshot(state, r)),
                 ("send", lambda: sim._send_phase(state, r)),
                 ("deliver", lambda: sim._deliver_phase(state, r)),
                 ("reply", lambda: sim._reply_phase(state, r)),
                 ("eval", lambda: sim._eval_phase(state, r)))
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
    tol = REF_TOL + ring_step(torch, sim, st_c, wire)
    diff = (p_c - p_g).abs()
    worst = float((diff - tol).max())
    log(f"[reference] {label}: 8-node CIFAR10Net, 3 rounds, card vs CPU: max "
        f"abs param diff {float(diff.max()):.3e}, worst margin to the "
        f"tolerance {worst:.3e} (<= 0 passes); launches card {l_g}, CPU "
        f"{l_c}; slots {(r_g.compact_slots_per_round + r_g.wide_slots_per_round).tolist()}")
    if worst > 0 or l_c != 0 or (l_g == 0) != (fused is False):
        raise RuntimeError(f"{label}: card run does not agree with the CPU "
                           "run")


def northstar_sim(torch, device, seed: int = 42, **kw):
    """``bench.py::build_sim`` through the port's entry points, on
    ``device``, with the draws of ``TorchDraws(seed)`` and the initial
    weights of a generator seeded with ``seed``; ``kw`` goes to the
    simulator (the default deliver unless it names another)."""
    from gossipy_tpu_torch.core import (AntiEntropyProtocol, CreateModelMode,
                                        Topology)
    from gossipy_tpu_torch.data import (ClassificationDataHandler,
                                        DataDispatcher,
                                        load_classification_dataset)
    from gossipy_tpu_torch.handlers import SGDHandler, losses
    from gossipy_tpu_torch.models import LogisticRegression
    from gossipy_tpu_torch.random import TorchDraws
    from gossipy_tpu_torch.simulation import GossipSimulator

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the offline stand-in's note
        X, y = load_classification_dataset("spambase")
    dh = ClassificationDataHandler(X, y, test_size=0.2, seed=42)
    stacked = DataDispatcher(dh, n=NS_NODES, eval_on_user=False).stacked()
    topology = Topology.random_regular(NS_NODES, NS_DEGREE, seed=42,
                                       backend="networkx")
    d = X.shape[1]
    handler = SGDHandler(LogisticRegression(d, 2), losses.cross_entropy,
                         learning_rate=0.1, local_epochs=1, batch_size=32,
                         n_classes=2, input_shape=(d,),
                         create_model_mode=CreateModelMode.MERGE_UPDATE)
    kw = {"fused_merge": False, "protocol": AntiEntropyProtocol.PUSH, **kw}
    sim = GossipSimulator(handler, topology, stacked, delta=100,
                          draws=TorchDraws(seed), device=device, **kw)
    state = sim.init_nodes(torch.Generator().manual_seed(seed))
    return sim, state


class MergeAudit:
    """Holds every merge kernel call of one card run, as it happens,
    against its plain version on the same tables: the kernel's own output
    on the path's own inputs (the plain version launches nothing). Counts,
    per kernel, the calls, the tables that read ring cells older than the
    round's own (delayed messages), the reply phase's tables, and the
    worst error."""

    def __init__(self, torch, merge, sim):
        from gossipy_tpu_torch.simulation import engine
        self.torch, self.merge, self.sim, self.engine = \
            torch, merge, sim, engine
        self.phase, self.r = "deliver", 0
        self.stats = {}

    def __enter__(self):
        e, m = self.engine, self.merge
        self._saved = (e.gather_merge_multi, e.gather_merge_flat)
        e.gather_merge_multi = self._wrap(e.gather_merge_multi,
                                          m.gather_merge_multi_reference)
        e.gather_merge_flat = self._wrap(e.gather_merge_flat,
                                         m.gather_merge_reference)
        for phase in ("deliver", "reply"):
            run = getattr(self.sim, f"_{phase}_phase")

            def tagged(state, r, run=run, phase=phase):
                self.phase, self.r = phase, r
                return run(state, r)
            setattr(self.sim, f"_{phase}_phase", tagged)
        return self

    def __exit__(self, *exc):
        self.engine.gather_merge_multi, self.engine.gather_merge_flat = \
            self._saved
        del self.sim._deliver_phase, self.sim._reply_phase
        return False

    def _wrap(self, fn, plain):
        def call(p, h, idx, w_self, w_peer, scale=None, leaf_starts=None):
            before = dict(self.merge.LAUNCHES)
            out = fn(p, h, idx, w_self, w_peer, scale, leaf_starts)
            launched = [k for k, v in self.merge.LAUNCHES.items()
                        if v != before.get(k, 0)]
            if len(launched) != 1:
                raise RuntimeError(f"a merge call launched {launched}")
            want = plain(p, h, idx, w_self, w_peer, scale, leaf_starts)
            err = float((out - want).abs().max())
            n = self.sim.n_nodes
            cells = idx.long()[w_peer != 0] // n
            depth = h.shape[0] // n
            s = self.stats.setdefault(launched[0], {
                "calls": 0, "older_cells": 0, "reply": 0, "max_abs_err": 0.0})
            s["calls"] += 1
            s["older_cells"] += int(bool((cells != self.r % depth).any()))
            s["reply"] += int(self.phase == "reply")
            if not err <= s["max_abs_err"]:
                s["max_abs_err"] = err
            if not err <= KERNEL_TOL:
                raise RuntimeError(f"{launched[0]}: {err} off its plain "
                                   f"version on the {self.phase} tables of "
                                   f"round {self.r}")
            return out
        return call


def check_same_accounting(torch, label, st_c, st_g, r_c, r_g) -> None:
    """The CPU run (``st_c``, ``r_c``) and the card run: equal per-round
    accounting, failures by cause, both boxes and ages."""
    for field in ("sent_per_round", "failed_per_round",
                  "mailbox_hwm_per_round", "compact_slots_per_round",
                  "wide_slots_per_round"):
        if not np.array_equal(getattr(r_c, field), getattr(r_g, field)):
            raise RuntimeError(f"{label}: card and CPU differ in {field}")
    for cause, v in r_c.failed_per_cause.items():
        if not np.array_equal(v, r_g.failed_per_cause[cause]):
            raise RuntimeError(f"{label}: card and CPU differ in {cause}")
    for box in ("mailbox", "reply_box"):
        for a, b in zip(getattr(st_c, box), getattr(st_g, box)):
            if not torch.equal(a, b.cpu()):
                raise RuntimeError(f"{label}: card and CPU {box} differ")
    if not torch.equal(st_c.model.n_updates, st_g.model.n_updates.cpu()):
        raise RuntimeError(f"{label}: card and CPU ages differ")


def ns_card_vs_cpu(torch, merge, label: str, wire: str = "float32",
                   **kw) -> dict:
    """NS_CHECK_ROUNDS rounds of the north-star configuration (with
    ``kw``) on the CPU and on the card from the same seeds: equal
    accounting and boxes, params within REF_TOL (plus half a bf16 step of
    the value for a bf16 ring); on the card, every merge call held to its
    plain version (:class:`MergeAudit`). Returns the audit's stats and
    the card run's launches per kernel."""
    runs = {}
    for dev in ("cpu", "cuda"):
        sim, state = northstar_sim(torch, dev, seed=3, history_dtype=wire,
                                   **kw)
        merge.reset_launch_counts()
        audit = MergeAudit(torch, merge, sim)
        with audit if dev == "cuda" else contextlib.nullcontext():
            state, rep = sim.start(state, n_rounds=NS_CHECK_ROUNDS)
        runs[dev] = (state, rep, {k: v for k, v in merge.LAUNCHES.items()
                                  if v}, audit.stats)
    (st_c, r_c, l_c, _), (st_g, r_g, l_g, stats) = runs["cpu"], runs["cuda"]
    check_same_accounting(torch, label, st_c, st_g, r_c, r_g)
    p_c, p_g = st_c.model.params, st_g.model.params.cpu()
    tol = REF_TOL + ring_step(torch, sim, st_c, wire)
    diff = (p_c - p_g).abs()
    worst = float((diff - tol).max())
    causes = {c: int(v.sum()) for c, v in r_g.failed_per_cause.items()}
    log(f"[northstar] {label}: {NS_CHECK_ROUNDS} rounds, card vs CPU: sent "
        f"{int(r_g.sent_per_round.sum())}, failed {causes}, slots "
        f"{(r_g.compact_slots_per_round + r_g.wide_slots_per_round).tolist()}"
        f", max abs param diff {float(diff.max()):.3e}, worst margin to the "
        f"tolerance {worst:.3e} (<= 0 passes); final accuracy card "
        f"{r_g.final('accuracy')}, CPU {r_c.final('accuracy')}; launches "
        f"card {l_g}, CPU {l_c}; merge calls held to the plain versions "
        f"{stats}")
    if worst > 0 or l_c or not np.isfinite(r_g.final("accuracy")):
        raise RuntimeError(f"{label}: card run does not agree with the CPU "
                           "run")
    if bool(l_g) != bool(kw.get("fused_merge", False)):
        raise RuntimeError(f"{label}: launches {l_g} on the card; a fused "
                           "path launches its kernel, the plain one none")
    return {"stats": stats, "launches": l_g}


def ns_timed(torch, merge, label: str, fused) -> dict:
    """One leg of the north-star configuration timed as ``bench.py``
    times it: a warm-up, then BENCH_ROUNDS rounds from the same initial
    state and the same draws, the card synchronised before the host clock
    stops. Launch counts are set to 0 just before the timed rounds."""
    import copy

    from gossipy_tpu_torch.random import TorchDraws
    sim, state0 = northstar_sim(torch, "cuda", fused_merge=fused)
    warm, _ = sim.start(copy.deepcopy(state0), n_rounds=NS_WARMUP_ROUNDS)
    torch.cuda.synchronize()
    sim.draws = TorchDraws(42)
    state = copy.deepcopy(state0)
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    state, rep = sim.start(state, n_rounds=BENCH_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in merge.LAUNCHES.items() if v}
    compact, wide = rep.compact_slots_per_round, rep.wide_slots_per_round
    with_msgs = int(((compact + wide) > 0).sum())
    acc = rep.final("accuracy")
    if not torch.isfinite(state.model.params).all() or not np.isfinite(acc):
        raise RuntimeError(f"{label}: non-finite params or accuracy")
    want = {merge.KERNEL: with_msgs} if fused == "multi" else {}
    if launches != want or (fused == "multi" and with_msgs == 0):
        raise RuntimeError(f"{label}: launches {launches}, the path must "
                           f"make {want}")
    idle = profile(torch, lambda: sim._round(state),
                   f"north star {label}, one round with eval")
    log(f"[northstar] {label}: {BENCH_ROUNDS} rounds in {wall:.3f} s = "
        f"{BENCH_ROUNDS / wall:.2f} rounds/s ({wall / BENCH_ROUNDS * 1e3:.4f}"
        f" ms/round); sent {int(rep.sent_per_round.sum())}, failed "
        f"{int(rep.failed_per_round.sum())}, slots compact "
        f"{int(compact.sum())} wide {int(wide.sum())}; final global accuracy"
        f" {acc}; launches {launches}; idle share of one round {idle}")
    phase_times(torch, sim, state, f"north star {label}")
    return {"rounds_per_s": BENCH_ROUNDS / wall, "accuracy": acc,
            "launches": launches, "idle_share": idle}


def northstar_phase(torch, merge, rate) -> dict:
    """Phase 7 (a)-(c); returns the launches per path of each (kernel,
    ring format)."""
    from gossipy_tpu_torch.core import AntiEntropyProtocol, UniformDelay
    paths = {}
    # (a) the two legs, card against CPU
    for label, fused in (("default", False), ("multi", "multi")):
        ns_card_vs_cpu(torch, merge, label, fused_merge=fused)
    # K1, K2 and K3 against their plain versions, timed, at the shapes the
    # north star gives them: 100 rows of LogReg's stride, the derived K
    # slots (one for K3), a two-cell ring.
    sim, _ = northstar_sim(torch, "cpu")
    layout = sim.handler.layout
    starts = [layout.offsets[leaf] for leaf, _ in layout.leaves]
    check_merge(torch, merge, NS_NODES, 2, layout.stride, sim.K, 21, rate)
    check_wire_kernel(torch, merge, "multi", "bfloat16", NS_NODES, 2,
                      layout.stride, sim.K, starts, 22, rate)
    check_wire_kernel(torch, merge, "single", "float32", NS_NODES, 2,
                      layout.stride, 1, starts, 23, rate)
    # (b) rounds per second of each leg
    for label, fused in (("default", False), ("multi", "multi")):
        out = ns_timed(torch, merge, label, fused)
        for k, v in out["launches"].items():
            paths.setdefault((k, "float32"), {})[f"northstar-{label}"] = v
    # (c) the paper examples' network model
    net = dict(delay=UniformDelay(0, 10), drop_prob=0.1, online_prob=0.2,
               sampling_eval=0.1)
    push_pull = AntiEntropyProtocol.PUSH_PULL
    cases = (("danner-multi-bf16", "bfloat16", dict(fused_merge="multi")),
             ("danner-push_pull-multi", "float32",
              dict(fused_merge="multi", protocol=push_pull)),
             ("danner-push_pull-per_slot", "float32",
              dict(fused_merge="per_slot", protocol=push_pull)),
             ("danner-async-multi", "float32",
              dict(fused_merge="multi", sync=False)))
    need = {"danner-multi-bf16": (merge.KERNEL_MULTI_DQ, "older_cells"),
            "danner-push_pull-multi": (merge.KERNEL, "reply"),
            "danner-push_pull-per_slot": (merge.KERNEL_FLAT, "reply"),
            "danner-async-multi": (merge.KERNEL, "older_cells")}
    for label, wire, kw in cases:
        out = ns_card_vs_cpu(torch, merge, label, wire=wire, **net, **kw)
        kernel, what = need[label]
        s = out["stats"].get(kernel, {})
        if not s.get(what) or not out["launches"].get(kernel):
            raise RuntimeError(f"{label}: {kernel} never ran on {what} "
                               f"tables ({out['stats']})")
        for k, v in out["launches"].items():
            paths.setdefault((k, wire), {})[label] = v
    return paths


def flagship_run(torch, merge, flag, stacked, n, bf16, wire, device,
                 rounds, audit=False):
    """The flagship's multi path from its twin's functions, on ``device``
    with ``TorchDraws(42)`` and initial weights seeded with 42, ``rounds``
    rounds after ``init_nodes``; on the card with ``audit``, every merge
    call held to its plain version (:class:`MergeAudit`). Returns the
    simulator, the state, the report, the launches per kernel and the
    audit's stats."""
    sim = flag.flagship_sim(stacked, n, bf16, "multi", wire, device=device)
    state = sim.init_nodes(torch.Generator().manual_seed(42),
                           common_init=True)
    merge.reset_launch_counts()
    check = MergeAudit(torch, merge, sim) if audit \
        else contextlib.nullcontext()
    with check:
        state, rep = sim.start(state, n_rounds=rounds)
    launches = {k: v for k, v in merge.LAUNCHES.items() if v}
    return sim, state, rep, launches, (check.stats if audit else None)


def ring_step(torch, sim, state, wire):
    """One encoding step of the ring per param (half a bf16 step of the
    value, half an int8 quantum of the leaf), 0 for an fp32 ring."""
    p = state.model.params
    if wire == "bfloat16":
        return 2.0 ** -8 * p.abs()
    if wire == "int8":
        quantum = 0.5 * state.history_scale.amax(dim=(0, 1))
        return quantum[sim._col_leaf.cpu()].expand_as(p)
    return torch.zeros_like(p)


def flagship_card_vs_cpu(torch, merge, flag, sets) -> dict:
    """Phase 8 (a): FLAG_CHECK_ROUNDS rounds of the flagship at
    FLAG_CHECK_NODES nodes and FLAG_CHECK_SUBSAMPLE images on the CPU and
    on the card from the same seeds, fp32 compute with an fp32 ring, then
    bf16 compute with fp32, bf16 and int8 rings. Accounting and both boxes
    equal; every K1 and K2 call of the card runs bit-equal to its plain
    version on the same tables; the params by the rule of PERF.md §2,
    against ``effect``, what bf16 compute moves the CPU's fp32 run:

    - fp32: the median element within REF_TOL, the largest within the
      largest effect (a ReLU or max-pool decision near a tie may go the
      other way on the card: a whole gradient term on one node, which
      the later steps and merges carry on; an fp32 run may not stray
      further than bf16 compute moves it);
    - bf16: the largest and the median element within twice the effect's
      (two bf16 runs are each a perturbation of the fp32 run), plus one
      encoding step of a bf16 or int8 ring; and the card's bf16 run moves
      at least half the median effect away from the fp32 run.

    Returns the launches per (kernel, ring) of the card runs."""
    stacked = flag.flagship_data(FLAG_CHECK_NODES, FLAG_CHECK_SUBSAMPLE,
                                 sets=sets)
    cases = (("fp32", False, "float32"), ("bf16", True, "float32"),
             ("bf16-ring-bf16", True, "bfloat16"),
             ("bf16-ring-int8", True, "int8"))
    runs = {}
    for label, bf16, wire in cases:
        t0 = time.perf_counter()
        cpu = flagship_run(torch, merge, flag, stacked, FLAG_CHECK_NODES,
                           bf16, wire, "cpu", FLAG_CHECK_ROUNDS)
        t1 = time.perf_counter()
        card = flagship_run(torch, merge, flag, stacked, FLAG_CHECK_NODES,
                            bf16, wire, "cuda", FLAG_CHECK_ROUNDS,
                            audit=True)
        runs[label] = (cpu, card, t1 - t0, time.perf_counter() - t1)
    p32 = runs["fp32"][0][1].model.params
    effect = (runs["bf16"][0][1].model.params - p32).abs()
    eff_max, eff_med = float(effect.max()), float(effect.median())
    paths = {}
    for label, bf16, wire in cases:
        (sim, st_c, r_c, l_c, _), (_, st_g, r_g, l_g, stats), t_c, t_g = \
            runs[label]
        check_same_accounting(torch, f"flagship {label}", st_c, st_g, r_c,
                              r_g)
        kernel = merge.KERNEL if wire == "float32" else merge.KERNEL_MULTI_DQ
        with_msgs = int(((r_g.compact_slots_per_round
                          + r_g.wide_slots_per_round) > 0).sum())
        calls = stats.get(kernel, {}).get("calls", 0)
        if l_c or l_g != {kernel: with_msgs} or calls != with_msgs \
                or with_msgs == 0:
            raise RuntimeError(f"flagship {label}: launches card {l_g}, CPU "
                               f"{l_c}, audited calls {stats}; the path "
                               f"makes {{{kernel}: {with_msgs}}}")
        p_c, p_g = st_c.model.params, st_g.model.params.cpu()
        diff = (p_c - p_g).abs()
        step = ring_step(torch, sim, st_c, wire)
        d_max, d_med = float(diff.max()), float(diff.median())
        if bf16:
            lim_max = 2 * eff_max + float(step.max())
            lim_med = 2 * eff_med + float(step.median())
            moved = float((p_g - p32).abs().median())
            ok = d_max <= lim_max and d_med <= lim_med \
                and moved >= 0.5 * eff_med
        else:
            lim_max, lim_med, moved = eff_max, REF_TOL, None
            ok = d_max <= lim_max and d_med <= lim_med
        finite = bool(torch.isfinite(p_g).all()) and \
            np.isfinite(r_g.final("accuracy"))
        log(f"[flagship] card vs CPU {label} (ring {wire}): "
            f"{FLAG_CHECK_NODES} nodes, {FLAG_CHECK_SUBSAMPLE} images, S = "
            f"{sim.data['mtr'].shape[1]}, {FLAG_CHECK_ROUNDS} rounds: sent "
            f"{int(r_g.sent_per_round.sum())}, slots "
            f"{r_g.wide_slots_per_round.tolist()}; params max abs diff "
            f"{d_max:.3e} (limit {lim_max:.3e}), median {d_med:.3e} (limit "
            f"{lim_med:.3e}); bf16 effect max {eff_max:.3e} median "
            f"{eff_med:.3e}; card bf16 run from CPU fp32, median {moved}; "
            f"accuracy card {r_g.final('accuracy')}, CPU "
            f"{r_c.final('accuracy')}; launches {l_g}; merge calls held "
            f"to the plain versions {stats}; CPU {t_c:.1f} s, card "
            f"{t_g:.1f} s")
        if not (ok and finite):
            raise RuntimeError(f"flagship {label}: the card run does not "
                               "agree with the CPU run")
        paths.setdefault((kernel, wire), {})[f"flagship-check-{label}"] = \
            l_g[kernel]
    return paths


def flagship_timed(torch, merge, flag, stacked, wire: str) -> dict:
    """Phase 8 (b), one ring leg: the full-width flagship (FLAG_NODES
    nodes, bf16 compute, multi), a warm-up round, then FLAG_ROUNDS timed
    rounds, the card synchronised before the host clock stops; launches
    (counts set to 0 just before the timed rounds), the final sampled
    accuracy, the memory budget and the peak allocation, one profiled
    round and the phase times."""
    kernel = merge.KERNEL if wire == "float32" else merge.KERNEL_MULTI_DQ
    label = f"multi-{wire}"
    sim = flag.flagship_sim(stacked, FLAG_NODES, True, "multi", wire,
                            device="cuda")
    torch.cuda.reset_peak_memory_stats()
    state = sim.init_nodes(torch.Generator().manual_seed(42),
                           common_init=True)
    state, _ = sim.start(state, n_rounds=1)     # warm-up round
    torch.cuda.synchronize()
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    state, rep = sim.start(state, n_rounds=FLAG_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for k, v in merge.LAUNCHES.items() if v}
    with_msgs = int(((rep.compact_slots_per_round
                      + rep.wide_slots_per_round) > 0).sum())
    if launches != {kernel: with_msgs} or with_msgs != FLAG_ROUNDS:
        raise RuntimeError(f"flagship {label}: launches {launches}, the "
                           f"path must make {{{kernel}: {with_msgs}}} in "
                           f"{FLAG_ROUNDS} rounds with messages")
    acc = rep.final("accuracy")
    stride = sim.handler.layout.stride
    if state.model.params.shape != (FLAG_NODES, stride) or not \
            torch.isfinite(state.model.params).all() or not np.isfinite(acc):
        raise RuntimeError(f"flagship {label}: output has the wrong shape "
                           "or is not finite")
    budget = sim.memory_budget()
    idle = profile(torch, lambda: sim._round(state),
                   f"flagship {label}, one round with eval")
    log(f"[flagship] {label}: {FLAG_NODES}-node CIFAR10Net (stride "
        f"{stride}), bf16 compute, S = {sim.data['mtr'].shape[1]}, K = "
        f"{sim.K}, {FLAG_ROUNDS} rounds in {wall:.3f} s = "
        f"{wall / FLAG_ROUNDS * 1e3:.3f} ms/round; sent "
        f"{int(rep.sent_per_round.sum())}, failed "
        f"{int(rep.failed_per_round.sum())}; final sampled accuracy {acc}; "
        f"launches {launches}; idle share of one round {idle}; memory "
        f"budget {budget['total_bytes']} B ({budget['total_bytes'] / 2**30:.3f}"
        f" GiB: data {budget['data_bytes']}, ring "
        f"{budget['history_ring_bytes']}, model and optimizer "
        f"{budget['model_and_opt_bytes']}, eval {budget['eval_peak_bytes']})"
        f"; peak allocated {peak} B ({peak / 2**30:.3f} GiB)")
    phase_times(torch, sim, state, f"flagship {label}")
    return {"ms_per_round": wall / FLAG_ROUNDS * 1e3, "accuracy": acc,
            "launches": launches, "idle_share": idle,
            "budget_bytes": budget["total_bytes"], "peak_bytes": peak}


def flagship_phase(torch, merge, rate) -> tuple:
    """Phase 8: (a) the card against the CPU at a reduced size, K1 and K2
    at the flagship's shape, (b) the three timed ring legs at full width.
    Returns the launches per (kernel, ring) and path, and K1's and K2's
    numbers at the flagship shape."""
    from gossipy_tpu_torch.data import get_CIFAR10, to_device
    from gossipy_tpu_torch.examples import main_cifar10_100nodes as flag

    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the synthetic stand-in's note
        sets = get_CIFAR10()
    log(f"[flagship] CIFAR-10 stand-in, 50,000 + 10,000 images, made in "
        f"{time.perf_counter() - t0:.1f} s")
    paths = flagship_card_vs_cpu(torch, merge, flag, sets)
    t0 = time.perf_counter()
    stacked = to_device(flag.flagship_data(FLAG_NODES, sets=sets), "cuda")
    del sets
    log(f"[flagship] {FLAG_NODES} Dirichlet(0.5) shards padded to "
        f"{stacked['mtr'].shape[1]} rows and on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    # K1 and K2 at the flagship's shape: 100 rows of CIFAR10Net's stride,
    # the derived K, the two-cell ring.
    probe = flag.flagship_sim(stacked, FLAG_NODES, True, "multi",
                              device="cuda")
    layout = probe.handler.layout
    starts = [layout.offsets[leaf] for leaf, _ in layout.leaves]
    shape = dict(n=FLAG_NODES, d=2, f=layout.stride, k=probe.K)
    at_shape = {("multi", "float32"): check_merge(
        torch, merge, shape["n"], shape["d"], shape["f"], shape["k"], 31,
        rate)}
    for seed, wire in enumerate(("bfloat16", "int8"), start=32):
        at_shape[("multi", wire)] = check_wire_kernel(
            torch, merge, "multi", wire, shape["n"], shape["d"], shape["f"],
            shape["k"], starts, seed, rate)
    del probe
    legs = {}
    for wire in FLAG_WIRES:
        legs[wire] = flagship_timed(torch, merge, flag, stacked, wire)
        for k, v in legs[wire]["launches"].items():
            paths.setdefault((k, wire), {})[f"flagship-{wire}"] = v
        torch.cuda.empty_cache()
    return paths, at_shape


PAPERS = ("ormandi", "berta", "hegedus", "danner")
PAPER_CHECK_SIZE = {"ormandi": 64, "berta": 64, "hegedus": 64, "danner": 16}
PAPER_CHECK_ROUNDS = 8
# Timed rounds at full width: the reference's 100 for Ormandi and
# Hegedus, 100 of Berta's 500 and 300 of Danner's 1000.
PAPER_ROUNDS = {"ormandi": 100, "berta": 100, "hegedus": 100, "danner": 300}
PAPER_METRIC = {"ormandi": ("accuracy", False), "berta": ("nmi", False),
                "hegedus": ("rmse", True), "danner": ("accuracy", False)}


def paper_sets():
    """The data the four paper examples read, made once: the normalised
    spambase stand-in and the ml-100k stand-in's ratings."""
    from gossipy_tpu_torch.data import (load_classification_dataset,
                                        load_recsys_dataset)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the stand-ins' notes
        return {"spambase": load_classification_dataset("spambase"),
                "ml-100k": load_recsys_dataset("ml-100k")}


def paper_sim(torch, name: str, sets: dict, size: int, device,
              seed: int = 42):
    """Example ``name``'s simulator, built by its twin's own functions on
    ``device`` with ``TorchDraws(seed)``, at ``size`` nodes (users for
    Hegedus; 0 = the example's full width), and its ``init_nodes`` state
    under a generator seeded with ``seed``."""
    from gossipy_tpu_torch.examples import main_berta_2014 as berta
    from gossipy_tpu_torch.examples import main_danner_2023 as danner
    from gossipy_tpu_torch.examples import main_hegedus_2020 as hegedus
    from gossipy_tpu_torch.examples import main_ormandi_2013 as ormandi
    if name == "ormandi":
        stacked, dim = ormandi.ormandi_data(size, seed, sets["spambase"])
        sim = ormandi.ormandi_sim(stacked, dim, seed=seed, device=device)
    elif name == "berta":
        stacked, dim = berta.berta_data(size, sets["spambase"])
        sim = berta.berta_sim(stacked, dim, seed, device=device)
    elif name == "hegedus":
        stacked, n_items = hegedus.hegedus_data(seed=seed, users=size,
                                                sets=sets["ml-100k"])
        sim = hegedus.hegedus_sim(stacked, n_items, seed, device=device)
    else:
        stacked, dim = danner.danner_data(size or 100, seed,
                                          sets["spambase"])
        sim = danner.danner_sim(stacked, dim, seed, device=device)
    state = sim.init_nodes(torch.Generator().manual_seed(seed))
    return sim, state


def rounds_with_messages(rep) -> int:
    return int(((rep.compact_slots_per_round
                 + rep.wide_slots_per_round) > 0).sum())


def paper_card_vs_cpu(torch, merge, name: str, sets: dict) -> dict:
    """Phase 9 (a), one example: PAPER_CHECK_ROUNDS rounds at
    PAPER_CHECK_SIZE nodes on the CPU and on the card from the same
    seeds. Accounting, both boxes and ages equal; params within REF_TOL
    plus REF_TOL of their magnitude (Pegasos's weights reach hundreds);
    Ormandi launches K1 once a round with messages on the card, every
    call bit-equal to its plain version (``MergeAudit``); the three
    others take the plain path and launch nothing. Returns the card run's
    launches."""
    runs = {}
    for dev in ("cpu", "cuda"):
        sim, state = paper_sim(torch, name, sets, PAPER_CHECK_SIZE[name],
                               dev, seed=3)
        merge.reset_launch_counts()
        audit = MergeAudit(torch, merge, sim)
        t0 = time.perf_counter()
        with audit if dev == "cuda" else contextlib.nullcontext():
            state, rep = sim.start(state, n_rounds=PAPER_CHECK_ROUNDS)
        runs[dev] = (sim, state, rep, {k: v for k, v in
                                       merge.LAUNCHES.items() if v},
                     audit.stats, time.perf_counter() - t0)
    (sim, st_c, r_c, l_c, _, t_c), (_, st_g, r_g, l_g, stats, t_g) = \
        runs["cpu"], runs["cuda"]
    label = f"papers {name}"
    check_same_accounting(torch, label, st_c, st_g, r_c, r_g)
    p_c, p_g = st_c.model.params, st_g.model.params.cpu()
    diff = (p_c - p_g).abs()
    worst = float((diff - REF_TOL * (1.0 + p_c.abs())).max())
    metric, local = PAPER_METRIC[name]
    m_c, m_g = r_c.final(metric, local), r_g.final(metric, local)
    with_msgs = rounds_with_messages(r_g)
    want = {merge.KERNEL: with_msgs} if sim.fused_merge == "multi" else {}
    calls = stats.get(merge.KERNEL, {}).get("calls", 0)
    log(f"[papers] {name} card vs CPU: {sim.n_nodes} nodes, S = "
        f"{sim.data['mtr'].shape[1]}, K = {sim.K}, deliver "
        f"{sim.fused_merge or 'plain'}, {PAPER_CHECK_ROUNDS} rounds: sent "
        f"{int(r_g.sent_per_round.sum())}, failed "
        f"{ {c: int(v.sum()) for c, v in r_g.failed_per_cause.items()} }, "
        f"slots compact {int(r_g.compact_slots_per_round.sum())} wide "
        f"{int(r_g.wide_slots_per_round.sum())}; max abs param diff "
        f"{float(diff.max()):.3e} (largest param {float(p_c.abs().max()):.3e}"
        f"), worst margin to the tolerance {worst:.3e} (<= 0 passes); final "
        f"{metric} card {m_g}, CPU {m_c}; launches card {l_g}, CPU {l_c}; "
        f"merge calls held to the plain versions {stats}; CPU {t_c:.1f} s, "
        f"card {t_g:.1f} s")
    if worst > 0 or not np.isfinite(m_g) or not \
            torch.isfinite(st_g.model.params).all():
        raise RuntimeError(f"{label}: the card run does not agree with the "
                           "CPU run")
    if l_c or l_g != want or (want and (with_msgs == 0
                                        or calls != with_msgs)):
        raise RuntimeError(f"{label}: launches card {l_g}, CPU {l_c}, "
                           f"audited calls {calls}; the path makes {want}")
    return l_g


def paper_timed(torch, merge, name: str, sets: dict) -> dict:
    """Phase 9 (b), one example at full width on the card: a warm-up
    round, then PAPER_ROUNDS timed rounds (every round's sampled eval
    included), the card synchronised before the host clock stops; the
    final metric, the launches (counts set to 0 just before the timed
    rounds; Ormandi's K1 once a round with messages), the memory budget
    beside the peak allocation, one profiled round's idle share and the
    phase times."""
    rounds = PAPER_ROUNDS[name]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim, state = paper_sim(torch, name, sets, 0, "cuda")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    state, _ = sim.start(state, n_rounds=1)     # warm-up round
    torch.cuda.synchronize()
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    state, rep = sim.start(state, n_rounds=rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for k, v in merge.LAUNCHES.items() if v}
    with_msgs = rounds_with_messages(rep)
    want = {merge.KERNEL: with_msgs} if sim.fused_merge == "multi" else {}
    metric, local = PAPER_METRIC[name]
    final = rep.final(metric, local)
    if launches != want or (want and with_msgs == 0):
        raise RuntimeError(f"papers {name}: launches {launches}, the path "
                           f"must make {want}")
    if not torch.isfinite(state.model.params).all() or \
            not np.isfinite(final):
        raise RuntimeError(f"papers {name}: non-finite params or {metric}")
    budget = sim.memory_budget()
    idle = profile(torch, lambda: sim._round(state),
                   f"papers {name}, one round with eval")
    log(f"[papers] {name}: {sim.n_nodes} nodes (stride "
        f"{sim.handler.layout.stride}, S = {sim.data['mtr'].shape[1]}, K = "
        f"{sim.K}, D = {state.history_ages.shape[0]}), deliver "
        f"{sim.fused_merge or 'plain'}, {rounds} rounds in {wall:.3f} s = "
        f"{wall / rounds * 1e3:.3f} ms/round (set-up {setup:.1f} s); sent "
        f"{int(rep.sent_per_round.sum())}, failed "
        f"{int(rep.failed_per_round.sum())}, slots compact "
        f"{int(rep.compact_slots_per_round.sum())} wide "
        f"{int(rep.wide_slots_per_round.sum())}; final "
        f"{'local' if local else 'global'} {metric} {final}; launches "
        f"{launches} for {with_msgs} rounds with messages; idle share of one "
        f"round {idle}; memory budget {budget['total_bytes']} B ("
        f"{budget['total_bytes'] / 2**20:.1f} MiB: data "
        f"{budget['data_bytes']}, ring {budget['history_ring_bytes']}, model "
        f"{budget['model_and_opt_bytes']}); peak allocated {peak} B ("
        f"{peak / 2**20:.1f} MiB)")
    phase_times(torch, sim, state, f"papers {name}")
    return {"ms_per_round": wall / rounds * 1e3, metric: final,
            "launches": launches, "idle_share": idle,
            "budget_bytes": budget["total_bytes"], "peak_bytes": peak}


def papers_phase(torch, merge, rate) -> tuple:
    """Phase 9: the four paper examples. (a) each on the card against the
    CPU at a cut size; K1 against its plain version, timed, at the
    Ormandi shape; (b) each timed at full width. Returns the launches per
    (kernel, ring) and run, and K1's numbers at the Ormandi shape."""
    t0 = time.perf_counter()
    sets = paper_sets()
    log(f"[papers] spambase and ml-100k stand-ins made in "
        f"{time.perf_counter() - t0:.1f} s")
    paths = {}
    for name in PAPERS:
        launched = paper_card_vs_cpu(torch, merge, name, sets)
        for k, v in launched.items():
            paths.setdefault((k, "float32"), {})[f"{name}-check"] = v
    # K1 at the Ormandi shape: 4,141 rows of AdaLine(57)'s 60-column
    # stride, the derived K, the ring's D cells.
    probe, state = paper_sim(torch, "ormandi", sets, 0, "cpu")
    depth = state.history_ages.shape[0]
    at_ormandi = check_merge(torch, merge, probe.n_nodes, depth,
                             probe.handler.layout.stride, probe.K, 41, rate)
    del probe, state
    for name in PAPERS:
        out = paper_timed(torch, merge, name, sets)
        for k, v in out["launches"].items():
            paths.setdefault((k, "float32"), {})[name] = v
        torch.cuda.empty_cache()
    return paths, at_ormandi


# -- phase 10: the variant simulators and the four examples they carry ------

# The configurations: (label, example, variant). Giaretta's three node
# behaviours, Hegedus 2021's two exchanges, All2All's two mixings,
# Onoszko's PENS, and the token-account simulator over the north star on
# the per-slot fused deliver with an fp32 ring (K3) and a bf16 ring (K4).
VARIANTS = (("giaretta-vanilla", "giaretta", "vanilla"),
            ("giaretta-passthrough", "giaretta", "passthrough"),
            ("giaretta-cacheneigh", "giaretta", "cacheneigh"),
            ("hegedus2021-partitioning", "hegedus2021", "partitioning"),
            ("hegedus2021-sampling", "hegedus2021", "sampling"),
            ("all2all-uniform", "all2all", "uniform"),
            ("all2all-metropolis", "all2all", "metropolis"),
            ("onoszko", "onoszko", None),
            ("tokenized-float32", "tokenized", "float32"),
            ("tokenized-bfloat16", "tokenized", "bfloat16"))
# Card-against-CPU sizes (nodes; Onoszko: 3 nodes and 96 images).
VARIANT_CHECK_SIZE = {"giaretta": 64, "hegedus2021": 32, "all2all": 32,
                      "onoszko": 3, "tokenized": NS_NODES}
VARIANT_CHECK_ROUNDS = 8
ONOSZKO_CHECK = dict(subsample=96, step1_rounds=3, rounds=5)
# Timed rounds at full width: Giaretta's and All2All's reference 100,
# 100 of Hegedus 2021's 1000, 100 of the tokenized north star. Onoszko's
# window is cut to ONOSZKO_STEP1 phase-1 rounds (of 100) and 2 phase-2
# rounds (of 400): 3 local epochs at batch 8 make 3,750 steps an update
# pass. Under seed 42 the first phase-1 merge falls in round 2 (the
# message flow does not depend on the weights: a host run with the
# updates stubbed out finds it); the timed run fails if it holds none.
# Its profile covers ONOSZKO_PROFILE_ROWS samples of each shard (30
# local steps), not a round of ~7,500 steps and ~2 million kernels.
VARIANT_ROUNDS = {"giaretta": 100, "hegedus2021": 100, "all2all": 100,
                  "tokenized": 100}
ONOSZKO_STEP1 = 3
ONOSZKO_ROUNDS = ONOSZKO_STEP1 + 2
ONOSZKO_PROFILE_ROWS = 80


def variant_sets() -> dict:
    """The spambase stand-in and the CIFAR-10 stand-in, made once."""
    from gossipy_tpu_torch.data import get_CIFAR10, \
        load_classification_dataset
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the stand-ins' notes
        return {"spambase": load_classification_dataset("spambase"),
                "cifar10": get_CIFAR10()}


def variant_sim(torch, label: str, sets: dict, full: bool, device,
                seed: int = 42, bf16: bool = False):
    """Configuration ``label`` of VARIANTS built by its twin's functions
    (the tokenized north star by ``northstar_sim``'s recipe) on
    ``device`` with ``TorchDraws(seed)``, at full width or at
    VARIANT_CHECK_SIZE, and its ``init_nodes`` state under a generator
    seeded with ``seed``. The checks run the token accounts as
    ``RandomizedTokenAccount(C=2, A=1)`` (Hegedus 2021) and
    ``SimpleTokenAccount(C=1)`` (north star), under which nodes send from
    the first rounds; the full-width Hegedus 2021 keeps the example's
    ``RandomizedTokenAccount(C=20, A=10)``."""
    from gossipy_tpu_torch.examples import main_all2all as all2all
    from gossipy_tpu_torch.examples import main_giaretta_2019 as giaretta
    from gossipy_tpu_torch.examples import main_hegedus_2021 as hegedus
    from gossipy_tpu_torch.examples import main_onoszko_2021 as onoszko
    from gossipy_tpu_torch.flow_control import RandomizedTokenAccount, \
        SimpleTokenAccount
    from gossipy_tpu_torch.random import TorchDraws
    _, example, variant = next(v for v in VARIANTS if v[0] == label)
    size = 0 if full else VARIANT_CHECK_SIZE[example]
    draws = TorchDraws(seed)
    if example == "giaretta":
        stacked, dim = giaretta.giaretta_data(size, seed, sets["spambase"])
        sim = giaretta.giaretta_sim(stacked, dim, variant, seed, draws,
                                    device)
    elif example == "hegedus2021":
        stacked, dim = hegedus.hegedus2021_data(size or 100, seed,
                                                sets["spambase"])
        account = None if full else RandomizedTokenAccount(C=2, A=1)
        sim = hegedus.hegedus2021_sim(stacked, dim, variant, seed, draws,
                                      device, token_account=account)
    elif example == "all2all":
        stacked, dim = all2all.all2all_data(size or 100, seed,
                                            sets["spambase"])
        sim = all2all.all2all_sim(stacked, dim, variant, seed, draws, device)
    elif example == "onoszko":
        sub = 0 if full else ONOSZKO_CHECK["subsample"]
        step1 = ONOSZKO_STEP1 if full else ONOSZKO_CHECK["step1_rounds"]
        stacked = onoszko.onoszko_data(size or 5, sub, sets["cifar10"])
        sim = onoszko.onoszko_sim(stacked, step1, seed, draws, device,
                                  bf16=bf16)
    else:
        return tokenized_northstar(torch, device, seed, variant)
    state = sim.init_nodes(torch.Generator().manual_seed(seed))
    return sim, state


def tokenized_northstar(torch, device, seed: int, wire: str):
    """The north-star configuration (``northstar_sim``) on the token
    simulator, ``SimpleTokenAccount(C=1)``, the per-slot fused deliver,
    ring ``wire``."""
    from gossipy_tpu_torch.core import AntiEntropyProtocol, CreateModelMode, \
        Topology
    from gossipy_tpu_torch.data import ClassificationDataHandler, \
        DataDispatcher, load_classification_dataset
    from gossipy_tpu_torch.flow_control import SimpleTokenAccount
    from gossipy_tpu_torch.handlers import SGDHandler, losses
    from gossipy_tpu_torch.models import LogisticRegression
    from gossipy_tpu_torch.random import TorchDraws
    from gossipy_tpu_torch.simulation import TokenizedGossipSimulator
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the offline stand-in's note
        X, y = load_classification_dataset("spambase")
    dh = ClassificationDataHandler(X, y, test_size=0.2, seed=42)
    stacked = DataDispatcher(dh, n=NS_NODES, eval_on_user=False).stacked()
    d = X.shape[1]
    handler = SGDHandler(LogisticRegression(d, 2), losses.cross_entropy,
                         learning_rate=0.1, local_epochs=1, batch_size=32,
                         n_classes=2, input_shape=(d,),
                         create_model_mode=CreateModelMode.MERGE_UPDATE)
    sim = TokenizedGossipSimulator(
        handler, Topology.random_regular(NS_NODES, NS_DEGREE, seed=42),
        stacked, token_account=SimpleTokenAccount(C=1), delta=100,
        protocol=AntiEntropyProtocol.PUSH, fused_merge="per_slot",
        history_dtype=wire, draws=TorchDraws(seed), device=device)
    state = sim.init_nodes(torch.Generator().manual_seed(seed))
    return sim, state


def variant_want(merge, sim, rep) -> dict:
    """The launches a run of ``sim`` must make: the single-pass deliver
    one K1 a round with messages, the per-slot one a K3 (fp32 ring) or a
    K4 (bf16, int8) per occupied slot, every other path none."""
    slots = rep.compact_slots_per_round + rep.wide_slots_per_round
    if sim.fused_merge == "multi":
        return {merge.KERNEL: int((slots > 0).sum())}
    if sim.fused_merge == "per_slot":
        kernel = merge.KERNEL_FLAT if sim.history_dtype == "float32" \
            else merge.KERNEL_FLAT_DQ
        return {kernel: int(slots.sum())}
    return {}


def check_same_aux(torch, label, st_c, st_g, tol) -> None:
    """Equal ``aux``: integers and masks exactly, floats (infinities in
    the same places) within ``tol`` plus ``tol`` of the value; a parked
    model in a bf16 or int8 wire format within one encoding step."""
    if sorted(st_c.aux) != sorted(st_g.aux):
        raise RuntimeError(f"{label}: card and CPU aux differ in keys")
    for k, a in st_c.aux.items():
        b = st_g.aux[k].cpu()
        if a.dtype in (torch.bfloat16, torch.int8):
            # One step of the wire format (an int8 code, a bf16 ulp).
            a, b = a.to(torch.float32), b.to(torch.float32)
            ok = ((a - b).abs() <= 1.0 + 2.0 ** -7 * a.abs()).all()
        elif a.is_floating_point():
            same_inf = torch.equal(torch.isinf(a), torch.isinf(b))
            fin = torch.isfinite(a)
            ok = same_inf and bool(((a - b).abs()[fin]
                                    <= tol * (1.0 + a.abs()[fin])).all())
        else:
            ok = torch.equal(a, b)
        if not ok:
            raise RuntimeError(f"{label}: card and CPU aux[{k!r}] differ")


def variant_run(torch, merge, label, sets, device, rounds, audit, seed=3,
                bf16=False):
    """``rounds`` rounds of ``label`` at its check size from the same
    seeds, counts set to 0 just before; on the card with ``audit``, every
    merge call held to its plain version (:class:`MergeAudit`)."""
    sim, state = variant_sim(torch, label, sets, False, device, seed, bf16)
    merge.reset_launch_counts()
    check = MergeAudit(torch, merge, sim) if audit \
        else contextlib.nullcontext()
    t0 = time.perf_counter()
    with check:
        state, rep = sim.start(state, n_rounds=rounds)
    launches = {k: v for k, v in merge.LAUNCHES.items() if v}
    return (sim, state, rep, launches, check.stats if audit else None,
            time.perf_counter() - t0)


def variant_card_vs_cpu(torch, merge, label: str, sets: dict) -> dict:
    """Phase 10 (a), one configuration at its check size on the CPU and
    on the card from the same seeds: accounting, both boxes, ages and
    ``aux`` equal; params within REF_TOL plus REF_TOL of their magnitude
    (plus one encoding step of a bf16 ring); Onoszko's CIFAR10Net by the
    decision-flip rule of PERF.md §2 (the median element within REF_TOL,
    the largest within what bf16 compute moves the CPU's run); the
    launches the path makes (:func:`variant_want`), every merge call
    bit-equal to its plain version. Returns the card run's launches."""
    rounds = (ONOSZKO_CHECK["rounds"] if label == "onoszko"
              else VARIANT_CHECK_ROUNDS)
    sim, st_c, r_c, l_c, _, t_c = variant_run(torch, merge, label, sets,
                                              "cpu", rounds, False)
    _, st_g, r_g, l_g, stats, t_g = variant_run(torch, merge, label, sets,
                                                "cuda", rounds, True)
    tag = f"variants {label}"
    check_same_accounting(torch, tag, st_c, st_g, r_c, r_g)
    check_same_aux(torch, tag, st_c, st_g, REF_TOL)
    if not torch.equal(st_c.history_ages, st_g.history_ages.cpu()):
        raise RuntimeError(f"{tag}: card and CPU ring ages differ")
    p_c, p_g = st_c.model.params, st_g.model.params.cpu()
    diff = (p_c - p_g).abs()
    if label == "onoszko":
        bf = variant_run(torch, merge, label, sets, "cpu", rounds, False,
                         bf16=True)[1].model.params
        effect = float((bf - p_c).abs().max())
        rule = (f"median {float(diff.median()):.3e} (limit {REF_TOL}), max "
                f"{float(diff.max()):.3e} (limit: bf16's effect {effect:.3e})")
        ok = float(diff.median()) <= REF_TOL and float(diff.max()) <= effect
    else:
        tol = REF_TOL * (1.0 + p_c.abs()) + ring_step(torch, sim, st_c,
                                                      sim.history_dtype)
        worst = float((diff - tol).max())
        rule = (f"max abs diff {float(diff.max()):.3e} (largest param "
                f"{float(p_c.abs().max()):.3e}), worst margin {worst:.3e} "
                "(<= 0 passes)")
        ok = worst <= 0
    metric = "accuracy"
    m_c, m_g = r_c.final(metric), r_g.final(metric)
    want = variant_want(merge, sim, r_g)
    calls = {k: s["calls"] for k, s in (stats or {}).items()}
    log(f"[variants] {label} card vs CPU: {sim.n_nodes} nodes, "
        f"{type(sim).__name__}, K = {sim.K}, deliver "
        f"{sim.fused_merge or 'plain'}, ring {sim.history_dtype}, {rounds} "
        f"rounds: sent {int(r_g.sent_per_round.sum())}, failed "
        f"{ {c: int(v.sum()) for c, v in r_g.failed_per_cause.items()} }, "
        f"slots compact {int(r_g.compact_slots_per_round.sum())} wide "
        f"{int(r_g.wide_slots_per_round.sum())}; params {rule}; final "
        f"{metric} card {m_g}, CPU {m_c}; launches card {l_g}, CPU {l_c}; "
        f"merge calls held to the plain versions {stats}; CPU {t_c:.1f} s, "
        f"card {t_g:.1f} s")
    if not ok or not np.isfinite(m_g) or not torch.isfinite(p_g).all():
        raise RuntimeError(f"{tag}: the card run does not agree with the "
                           "CPU run")
    if l_c or l_g != want or calls != want or (want and not
                                                sum(want.values())):
        raise RuntimeError(f"{tag}: launches card {l_g}, CPU {l_c}, "
                           f"audited calls {calls}; the path makes {want}")
    if int(r_g.sent_per_round.sum()) == 0:
        raise RuntimeError(f"{tag}: no message was sent")
    return l_g


def onoszko_steps(torch, sim, state):
    """A local update of every node over the first ONOSZKO_PROFILE_ROWS
    samples of its shard (3 epochs of 10 steps), as a function, and its
    step count: Onoszko's round is these steps, 3,750 an update pass."""
    h = sim.handler
    data = tuple(d[:, :ONOSZKO_PROFILE_ROWS] for d in sim._local_data())
    perms = sim.draws.update_permutations(
        state.round, [0], torch.zeros(sim.n_nodes, dtype=torch.int64,
                                      device=sim.device),
        h.local_epochs, ONOSZKO_PROFILE_ROWS)
    steps = h.local_epochs * -(-ONOSZKO_PROFILE_ROWS // h.batch_size)
    return (lambda: h.update(state.model, data, perms)), steps


def variant_timed(torch, merge, label: str, sets: dict) -> dict:
    """Phase 10 (b), one configuration at full width on the card: a
    warm-up round, then the timed rounds (every round's sampled eval
    included), the card synchronised before the host clock stops; the
    final metric, the launches (counts set to 0 just before the timed
    rounds), the memory budget beside the peak allocation, one profiled
    round's idle share and the phase times. Onoszko's window runs from
    round 0 (its first phase is part of what is timed) and must hold a
    phase-1 merge and two phase-2 rounds; its ms per local step is
    printed."""
    example = next(v[1] for v in VARIANTS if v[0] == label)
    onoszko = example == "onoszko"
    rounds = ONOSZKO_ROUNDS if onoszko else VARIANT_ROUNDS[example]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim, state = variant_sim(torch, label, sets, True, "cuda")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    if not onoszko:
        state, _ = sim.start(state, n_rounds=1)     # warm-up round
    torch.cuda.synchronize()
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    state, rep = sim.start(state, n_rounds=rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for k, v in merge.LAUNCHES.items() if v}
    want = variant_want(merge, sim, rep)
    metric = "accuracy"
    final = rep.final(metric)
    if launches != want or (want and not sum(want.values())):
        raise RuntimeError(f"variants {label}: launches {launches}, the "
                           f"path must make {want}")
    if not torch.isfinite(state.model.params).all() or \
            not np.isfinite(final) or rep.sent_messages == 0:
        raise RuntimeError(f"variants {label}: non-finite params or "
                           f"{metric}, or no message sent")
    extra = ""
    if onoszko:
        merged = int(state.aux["neigh_counter"].sum())
        if merged == 0 or rounds - ONOSZKO_STEP1 < 2:
            raise RuntimeError("variants onoszko: the timed window holds no "
                               "phase-1 merge or fewer than 2 phase-2 "
                               "rounds")
        steps_fn, steps = onoszko_steps(torch, sim, state)
        steps_fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        steps_fn()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t1) * 1e3 / steps
        extra = (f"; phase-1 merged models {merged}, best neighbours "
                 f"{int(state.aux['best'].sum())}; {step_ms:.4f} ms per "
                 f"local step of the 5 nodes ({steps} steps timed): "
                 f"{step_ms * 3750 / 1e3:.2f} s an update pass")
    budget = sim.memory_budget()
    if onoszko:
        idle = profile(torch, steps_fn, f"variants {label}, {steps} local "
                       "steps")
    else:
        idle = profile(torch, lambda: sim._round(state),
                       f"variants {label}, one round with eval")
    log(f"[variants] {label}: {sim.n_nodes} nodes, {type(sim).__name__} "
        f"(stride {sim.handler.layout.stride}, S = "
        f"{sim.data['mtr'].shape[1]}, K = {sim.K}, D = "
        f"{state.history_ages.shape[0]}), deliver "
        f"{sim.fused_merge or 'plain'}, ring {sim.history_dtype}, {rounds} "
        f"rounds in {wall:.3f} s = {wall / rounds * 1e3:.3f} ms/round "
        f"(set-up {setup:.1f} s); sent {int(rep.sent_per_round.sum())}, "
        f"failed {int(rep.failed_per_round.sum())}, slots compact "
        f"{int(rep.compact_slots_per_round.sum())} wide "
        f"{int(rep.wide_slots_per_round.sum())}; final sampled {metric} "
        f"{final}; launches {launches}; idle share of "
        f"{'the profiled steps' if onoszko else 'one round'} {idle}; "
        f"memory budget {budget['total_bytes']} B "
        f"({budget['total_bytes'] / 2**20:.1f} MiB: aux "
        f"{budget['aux_bytes']}, data {budget['data_bytes']}, ring "
        f"{budget['history_ring_bytes']}, model "
        f"{budget['model_and_opt_bytes']}); peak allocated {peak} B "
        f"({peak / 2**20:.1f} MiB){extra}")
    if example != "all2all" and not onoszko:
        phase_times(torch, sim, state, f"variants {label}")
    return {"ms_per_round": wall / rounds * 1e3, metric: final,
            "launches": launches, "idle_share": idle,
            "budget_bytes": budget["total_bytes"], "peak_bytes": peak}


def variants_phase(torch, merge, rate) -> tuple:
    """Phase 10: (a) each configuration on the card against the CPU at
    its check size; K1 against its plain version, timed, at Giaretta's
    shape, K3 and K4 (bf16) at the token north star's; (b) each timed at
    full width. Returns the launches per (kernel, ring) and run, and the
    kernels' numbers at those shapes."""
    t0 = time.perf_counter()
    sets = variant_sets()
    log(f"[variants] spambase and CIFAR-10 stand-ins made in "
        f"{time.perf_counter() - t0:.1f} s")
    paths = {}
    for label, _, _ in VARIANTS:
        for k, v in variant_card_vs_cpu(torch, merge, label, sets).items():
            wire = "bfloat16" if label.endswith("bfloat16") else "float32"
            paths.setdefault((k, wire), {})[f"{label}-check"] = v
    # K1 at Giaretta's shape: 4,141 rows of AdaLine(57)'s 60-column
    # stride, the derived K of the hubs' fan-in, the ring's cells; K3 and
    # K4 at the token north star's: 100 rows of LogReg's 116, one slot.
    probe, state = variant_sim(torch, "giaretta-vanilla", sets, True, "cpu")
    shapes = {"giaretta": check_merge(
        torch, merge, probe.n_nodes, state.history_ages.shape[0],
        probe.handler.layout.stride, probe.K, 51, rate)}
    probe, state = variant_sim(torch, "tokenized-float32", sets, True, "cpu")
    layout = probe.handler.layout
    starts = [layout.offsets[leaf] for leaf, _ in layout.leaves]
    for seed, wire in enumerate(("float32", "bfloat16"), start=52):
        shapes[("tokenized", wire)] = check_wire_kernel(
            torch, merge, "single", wire, probe.n_nodes,
            state.history_ages.shape[0], layout.stride, 1, starts, seed,
            rate)
    del probe, state
    for label, _, _ in VARIANTS:
        out = variant_timed(torch, merge, label, sets)
        for k, v in out["launches"].items():
            wire = "bfloat16" if label.endswith("bfloat16") else "float32"
            paths.setdefault((k, wire), {})[label] = v
        torch.cuda.empty_cache()
    return paths, shapes


def tensor_rate(name: str) -> float:
    for key, rate in TENSOR_FLOPS:
        if key in name:
            return rate
    raise RuntimeError(f"no tensor-core rate known for {name!r}")


def hop_arrays(sl_q, sl_k, dim, dv, carry, seed, neg, masked_rows=0):
    """float32 numpy operands of one attention hop from
    ``default_rng(seed)``: q, k_c, v_c and the initial carry (m = ``neg``,
    l = 0, acc = 0) or a mid-stream one (normal m, softplus l, normal acc),
    whose first ``masked_rows`` rows enter with m = ``neg``, l = 0,
    acc = 0. ``tests/test_torch_attention.py`` builds its cases with it."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((sl_q, dim), (sl_k, dim), (sl_k, dv)))
    if carry == "initial":
        m = np.full(sl_q, neg, np.float32)
        l = np.zeros(sl_q, np.float32)
        acc = np.zeros((sl_q, dv), np.float32)
    else:
        m = rng.normal(size=sl_q).astype(np.float32)
        l = np.log1p(np.exp(rng.normal(size=sl_q))).astype(np.float32)
        acc = rng.normal(size=(sl_q, dv)).astype(np.float32)
        m[:masked_rows] = neg
        l[:masked_rows] = 0.0
        acc[:masked_rows] = 0.0
    return q, k, v, m, l, acc


def hop_operands(torch, attn, sl_q, sl_k, dim, dv, dtype, carry, seed,
                 masked_rows=0):
    """:func:`hop_arrays` on the card, q, k_c, v_c in ``dtype``."""
    arrays = hop_arrays(sl_q, sl_k, dim, dv, carry, seed, attn._NEG,
                        masked_rows)
    dev = torch.device("cuda")
    return ([torch.from_numpy(a).to(dev, dtype) for a in arrays[:3]]
            + [torch.from_numpy(a).to(dev) for a in arrays[3:]])


def bf16_steps(torch, a, b):
    """The largest ``|a - b|`` of two ``[rows, cols]`` bf16 outputs in
    units of the bf16 step (the spacing of bf16 values) at the row's
    largest magnitude. An element near 0 has a far finer step of its own,
    below the rounding of the f32 sums that precede the cast."""
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).amax(dim=1, keepdim=True)
    step = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0 ** -126)))
                      - 7)
    return float(((a - b).abs() / step).max())


def check_hop(torch, attn, label, sl_q, sl_k, dim, dv, dtype, causal, offs,
              carry, seed, masked_rows=0) -> dict:
    """K5 against its plain version on the same operands: m within
    1e-5 max(1, |m|); l, acc and the normalized f32 output within 1e-4 of
    their largest magnitude; the bf16 output within one bf16 step at each
    row's largest magnitude."""
    ops = hop_operands(torch, attn, sl_q, sl_k, dim, dv, dtype, carry, seed,
                       masked_rows)
    scale = 1.0 / float(np.sqrt(dim))
    got = attn.flash_hop_update_cuda(*ops, *offs, scale, causal)
    want = attn.flash_hop_update_reference(*ops, *offs, scale, causal)
    torch.cuda.synchronize()
    (m_g, l_g, a_g), (m_w, l_w, a_w) = got, want
    if not all(torch.isfinite(t).all() for t in got):
        raise RuntimeError(f"K5 {label}: output is not finite")
    m_err = float(((m_g - m_w).abs() / m_w.abs().clamp_min(1.0)).max())
    out_g = a_g / l_g.clamp_min(1e-30)[:, None]
    out_w = a_w / l_w.clamp_min(1e-30)[:, None]
    errs = {name: float((g - w).abs().max()) for name, g, w in
            (("l", l_g, l_w), ("acc", a_g, a_w), ("out", out_g, out_w))}
    mags = {name: max(float(w.abs().max()), 1e-30) for name, w in
            (("l", l_w), ("acc", a_w), ("out", out_w))}
    out_bf16 = bf16_steps(torch, out_g.to(torch.bfloat16),
                          out_w.to(torch.bfloat16))
    log(f"[attention] K5 {attn.route(dtype, dim, dv)} {label}: sl_q={sl_q} "
        f"sl_k={sl_k} D={dim} Dv={dv} "
        f"{str(dtype).split('.')[-1]} causal={causal} offs={offs} "
        f"carry={carry}: m rel err {m_err:.3e}, "
        + ", ".join(f"{n} err {errs[n]:.3e} (of {mags[n]:.3e})"
                    for n in errs)
        + f", bf16 output steps {out_bf16}")
    if m_err > 1e-5 or any(errs[n] > 1e-4 * mags[n] for n in errs) \
            or out_bf16 > 1.0:
        raise RuntimeError(f"K5 {label} disagrees with its plain version")
    if masked_rows:
        if not (bool((l_g[:masked_rows] == 0).all())
                and bool((m_g[:masked_rows] == attn._NEG).all())):
            raise RuntimeError(f"K5 {label}: a wholly masked row with m = "
                               "_NEG did not keep l = 0 and m = _NEG")
    return dict(max_abs_err=errs["out"])


def dense_attention(torch, q, k, v, causal):
    """softmax(q k^T / sqrt(D)) v in f32 with the -1e30 causal mask, the
    JAX bench's dense yardstick (bench.py::bench_ring_attention)."""
    s = (q @ k.T) / float(np.sqrt(q.shape[1]))
    if causal:
        i = torch.arange(q.shape[0], device=q.device)
        s = torch.where(i[None, :] > i[:, None], -1e30, s)
    return torch.softmax(s, dim=-1) @ v


def attention_parity(torch, attn, q, k, v, tol: float = 5e-3) -> dict:
    """``bench.py::_attention_parity``'s rule, in f32 through autograd:
    forward max abs error < tol; gradient max abs error of mean(out^2)
    w.r.t. q, k, v < max(2 tol * grad scale, 1e-7), the scale being the
    dense gradients' largest magnitude."""
    def grads(fn):
        inputs = [t.float().detach().requires_grad_(True) for t in (q, k, v)]
        out = fn(*inputs)
        g = torch.autograd.grad((out.float() ** 2).mean(), inputs)
        return out.detach().float(), g

    attn.LAUNCHES.clear()
    o_f, g_f = grads(lambda a, b, c: attn.flash_attention(a, b, c,
                                                          causal=True))
    torch.cuda.synchronize()
    launches = attn.LAUNCHES[attn.KERNEL]
    o_d, g_d = grads(lambda a, b, c: dense_attention(torch, a, b, c, True))
    fwd_err = float((o_d - o_f).abs().max())
    grad_err = max(float((a - b).abs().max()) for a, b in zip(g_d, g_f))
    g_scale = max(float(g.abs().max()) for g in g_d)
    ok = (np.isfinite(fwd_err) and np.isfinite(grad_err) and fwd_err < tol
          and grad_err < max(2 * tol * g_scale, 1e-7))
    log(f"[attention] gradient check, flash_attention vs dense through "
        f"autograd, S={q.shape[0]} D={q.shape[1]} f32 causal: fwd max abs "
        f"err {fwd_err:.3e}, grad max abs err {grad_err:.3e}, grad scale "
        f"{g_scale:.3e}, K5 launches in forward + backward {launches}: "
        f"{'PASS' if ok else 'FAIL'}")
    if not ok or launches != 1:
        raise RuntimeError("flash_attention's gradient check failed (or K5 "
                           "did not launch exactly once)")
    return dict(fwd_err=fwd_err, grad_err=grad_err)


def attention_bound(rate, flop_rate, s_len, dim, causal, itemsize):
    """Least time of one ``flash_attention`` call at ``[s_len, dim]``: the
    unmasked (q, k) pairs' 2 (D + Dv) flops at ``flop_rate``; q, k, v read
    once at input width, the f32 carry read and written once."""
    pairs = s_len * (s_len + 1) // 2 if causal else s_len * s_len
    flops = 2 * pairs * (dim + dim)
    nbytes = 3 * s_len * dim * itemsize + 2 * 4 * (2 * s_len + s_len * dim)
    bytes_ms, flops_ms = nbytes / rate * 1e3, flops / flop_rate * 1e3
    return (max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms
            else "operations", nbytes, flops)


def sdpa_backend(torch, fn) -> str:
    """The name of the kernel that takes most of the device time of one
    ``fn()`` call under torch.profiler (SDPA's backend). When the profiler
    shows no device kernel (a later profiler session in one process may
    record none), the backend the dispatcher chooses for ``fn``'s
    operands, ``fn.sdpa_args``, by name."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace
    fn()
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and dev_us(e) > 0 and not e.key.startswith(
                   ("Activity", "Memcpy", "Memset"))]
    if kernels:
        return max(kernels, key=dev_us).key
    from torch.nn.attention import SDPBackend
    choice = torch._fused_sdp_choice(*fn.sdpa_args)
    return f"{SDPBackend(choice).name} (the dispatcher's choice)"


def f32_route_times(torch, attn, rate, name) -> dict:
    """The 3xTF32 route at the training shape (S = 8192, D = 128,
    non-causal, the demo's width): ``flash_attention`` with K5 (pre-pass
    included), through the plain version, and SDPA in f32 (TF32 off) as it
    chooses its backend and forced to the memory-efficient one, with the
    backend's kernel named; beside the bound at the TF32 tensor-core rate
    for three products a pair (the route's arithmetic) and at the f32 rate
    outside the tensor cores. Then ``flash_attention`` at the causal bench
    shape in f32 beside SDPA."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    q, k, v = hop_operands(torch, attn, ATTN_S, ATTN_S, ATTN_D, ATTN_D,
                           torch.float32, "initial", 40)[:3]
    err = check_output(torch, f"f32 route S={ATTN_S} D=Dv={ATTN_D} "
                       "non-causal", attn.flash_attention(q, k, v),
                       attn.flash_attention_reference(q, k, v))
    ms = time_ms(torch, lambda: attn.flash_attention(q, k, v), iters=10)
    plain_ms = time_ms(torch, lambda: attn.flash_attention_reference(q, k, v),
                       iters=10)
    q4, k4, v4 = (t[None, None] for t in (q, k, v))

    def sdpa(causal=False):
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)

    sdpa.sdpa_args = (q4, k4, v4)
    sdpa_ms = time_ms(torch, sdpa, iters=10)
    backend = sdpa_backend(torch, sdpa)
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        sdpa_eff_ms = time_ms(torch, sdpa, iters=10)
    tf32_rate = tensor_rate(name) * TF32_PER_BF16
    f32_rate_ms, _, nbytes, flops = attention_bound(rate, FP32_FLOPS, ATTN_S,
                                                    ATTN_D, False, 4)
    bound_ms, bound_by, _, _ = attention_bound(rate, tf32_rate / 3, ATTN_S,
                                               ATTN_D, False, 4)
    causal_ms = time_ms(torch, lambda: attn.flash_attention(q, k, v,
                                                            causal=True),
                        iters=10)
    sdpa_causal_ms = time_ms(torch, lambda: sdpa(True), iters=10)
    causal_bound = attention_bound(rate, tf32_rate / 3, ATTN_S, ATTN_D, True,
                                   4)[0]
    log(f"[attention] f32 route at the training shape S={ATTN_S} "
        f"D=Dv={ATTN_D} f32 non-causal: flash_attention (K5 "
        f"{attn.route(torch.float32, ATTN_D, ATTN_D)}, pre-pass included) "
        f"{ms:.5f} ms, through the plain hop {plain_ms:.5f} ms, SDPA f32 "
        f"{sdpa_ms:.5f} ms (kernel {backend}), SDPA forced to "
        f"EFFICIENT_ATTENTION {sdpa_eff_ms:.5f} ms; bound {bound_ms:.5f} ms "
        f"({nbytes} bytes, 3 x {flops} flops at the TF32 rate "
        f"{tf32_rate / 1e12:.1f} TFLOP/s, bound by {bound_by}), "
        f"{f32_rate_ms:.5f} ms at the f32 rate; K5 reaches "
        f"{bound_ms / ms:.4f} of its bound, {f32_rate_ms / ms:.4f} of the "
        f"f32-rate one. Causal bench shape f32: flash_attention "
        f"{causal_ms:.5f} ms, SDPA {sdpa_causal_ms:.5f} ms, bound "
        f"{causal_bound:.5f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=sdpa_ms, bound_ms=bound_ms, bound_by=bound_by,
                bound_f32_rate_ms=f32_rate_ms, sdpa_backend=backend)


def split_diffs(torch, attn, q, k, v) -> int:
    """The 32-bit words in which the pre-pass's planes differ from its
    plain version's on the same q, k, v (-1 when their shapes differ)."""
    got = attn.tf32_split(q, k, v)
    want = attn.tf32_split_reference(q, k, v)
    torch.cuda.synchronize()
    if any(g.shape != w.shape for g, w in zip(got, want)):
        return -1
    return sum(int((g.view(torch.int32) != w.view(torch.int32)).sum())
               for g, w in zip(got, want))


def check_output(torch, label, got, want) -> float:
    """``flash_attention``'s f32 output against its plain version's on the
    same inputs: finite, of its shape, within 1e-4 of the plain output's
    largest magnitude (``PERF.md`` §2). Returns the max abs error."""
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    mag = float(want.abs().max())
    log(f"[attention] {label}: flash_attention vs its plain version max abs "
        f"err {err:.3e} (of {mag:.3e})")
    if got.shape != want.shape or not bool(torch.isfinite(got).all()) \
            or err > 1e-4 * mag:
        raise RuntimeError(f"{label}: flash_attention disagrees with its "
                           "plain version")
    return err


def check_tf32_split(torch, attn, rate) -> dict:
    """The 3xTF32 routes' pre-pass against its plain version, bit for bit:
    ragged shapes for G = 3, 5, 6, 7 and 8 groups of 32 columns (1000 x 72
    q, 777 x 72 k, 777 x 40 v; 300 x 150 q with 261-key k and v of 150,
    130, 180, 200 and 256 columns) holding normal values, both zeros,
    negatives, exact rounding ties of the hi and of the lo part, values
    that round up into the next binade and subnormals; then, at the
    training shape (S = 8192, D = Dv = 128), bit for bit again and its
    device time beside the plain version and the bound (bytes: q, k, v
    read once, their planes written once)."""
    rng = np.random.default_rng(50)

    def edge(rows, cols):
        x = rng.normal(size=(rows, cols)).astype(np.float32)
        bits = x.view(np.uint32)
        n = bits.size
        picks = rng.choice(n, size=6 * (n // 7), replace=False).reshape(6, -1)
        bits.flat[picks[0]] = (bits.flat[picks[0]] & ~np.uint32(0x1FFF)) \
            | np.uint32(0x1000)                      # hi tie
        bits.flat[picks[1]] = (bits.flat[picks[1]] & ~np.uint32(0xFFF)) \
            | np.uint32(0x800)                       # lo tie
        bits.flat[picks[2]] |= np.uint32(0x7FFFFF)   # rounds to 2^(e+1)
        bits.flat[picks[3]] = np.uint32(0x80000000) * (picks[3] % 2)  # +-0
        bits.flat[picks[4]] = (bits.flat[picks[4]] & np.uint32(0x807FFFFF))
        bits.flat[picks[4][::2]] |= np.uint32(0x1000)  # subnormal ties
        bits.flat[picks[5]] ^= np.uint32(0x80000000)   # sign flips
        return torch.from_numpy(x).cuda()

    same, diffs, groups = True, 0, []
    for (sl_q, sl_k, dim, dv) in ((1000, 777, 72, 40), (300, 261, 150, 130),
                                  (300, 261, 150, 180), (300, 261, 150, 200),
                                  (300, 261, 150, 256)):
        n = split_diffs(torch, attn, edge(sl_q, dim), edge(sl_k, dim),
                        edge(sl_k, dv))
        groups.append(attn.tf32_groups(dim, dv))
        same = same and n == 0
        diffs += max(n, 0)
    q, k, v = hop_operands(torch, attn, ATTN_S, ATTN_S, ATTN_D, ATTN_D,
                           torch.float32, "initial", 41)[:3]
    timed_diffs = split_diffs(torch, attn, q, k, v)
    same = same and timed_diffs == 0
    ms = time_ms(torch, lambda: attn.tf32_split(q, k, v))
    plain_ms = time_ms(torch, lambda: attn.tf32_split_reference(q, k, v),
                       iters=10)
    nbytes = 3 * ATTN_S * ATTN_D * 4 * 3
    bound_ms, bound_by = bound(nbytes, 0, rate)
    log(f"[attention] tf32_split: kernel vs plain bit-equal {same} "
        f"({diffs} words differ) on ragged edge values at G = {groups}; at "
        f"S={ATTN_S} D=Dv={ATTN_D}: {timed_diffs} words differ, {ms:.5f} "
        f"ms, plain {plain_ms:.5f} ms, bound "
        f"{bound_ms:.5f} ms ({nbytes} bytes, bound by {bound_by}); reaches "
        f"{bound_ms / ms:.4f} of its bound")
    if not same:
        raise RuntimeError("tf32_split's kernel disagrees with its plain "
                           "version")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def f32_wide_run(torch, attn, rate, name) -> dict:
    """The wide f32 route's run: 3 ``flash_attention`` calls at S = 2048,
    D = Dv = 256, f32, causal (heads wider than ``flash_hop[f32]`` takes),
    launches counted from 0 (3 of ``flash_hop[f32-wide]``, 3 of its
    pre-pass), finite [S, Dv] outputs, the first held to the plain
    version's on the same q, k, v (:func:`check_output`), the pre-pass on
    them bit for bit to its plain version; then the device time of one call
    and of its pre-pass alone beside the plain version, SDPA in f32 and
    the bound at the TF32 rate for three products (the f32-rate bound
    printed beside it)."""
    import torch.nn.functional as F
    s_len, dim = 2048, 256
    q, k, v = hop_operands(torch, attn, s_len, s_len, dim, dim,
                           torch.float32, "initial", 42)[:3]
    attn.LAUNCHES.clear()
    outs = [attn.flash_attention(q, k, v, causal=True) for _ in range(3)]
    torch.cuda.synchronize()
    launches = dict(attn.LAUNCHES)
    if launches.get(attn.F32_WIDE_ROUTE) != 3 or launches.get(
            attn.SPLIT_KERNEL) != 3 or launches.get(
            attn.F32_ROUTE) or not all(
            o.shape == (s_len, dim) and bool(torch.isfinite(o).all())
            for o in outs):
        raise RuntimeError(f"the wide f32 run launched {launches} for 3 "
                           "calls, or its output is not finite [S, Dv]")
    err = check_output(torch, f"wide f32 run S={s_len} D=Dv={dim} causal",
                       outs[0], attn.flash_attention_reference(q, k, v,
                                                               causal=True))
    del outs
    split_words = split_diffs(torch, attn, q, k, v)
    if split_words:
        raise RuntimeError(f"the wide run's pre-pass differs from its plain "
                           f"version in {split_words} words")
    ms = time_ms(torch, lambda: attn.flash_attention(q, k, v, causal=True),
                 iters=10)
    split_ms = time_ms(torch, lambda: attn.tf32_split(q, k, v), iters=10)
    plain_ms = time_ms(torch, lambda: attn.flash_attention_reference(
        q, k, v, causal=True), iters=10)
    q4, k4, v4 = (t[None, None] for t in (q, k, v))
    sdpa_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), iters=10)
    bound_ms, bound_by, _, flops = attention_bound(
        rate, tensor_rate(name) * TF32_PER_BF16 / 3, s_len, dim, True, 4)
    f32_rate_ms = attention_bound(rate, FP32_FLOPS, s_len, dim, True, 4)[0]
    log(f"[attention] wide f32 run S={s_len} D=Dv={dim} causal: "
        f"{launches.get(attn.F32_WIDE_ROUTE)} launches of "
        f"{attn.F32_WIDE_ROUTE} and {launches.get(attn.SPLIT_KERNEL)} of "
        f"{attn.SPLIT_KERNEL} in 3 calls, output max abs err {err:.3e}, "
        f"pre-pass bit-equal; flash_attention {ms:.5f} ms "
        f"(pre-pass alone {split_ms:.5f} ms), plain {plain_ms:.5f} ms, SDPA "
        f"f32 {sdpa_ms:.5f} ms; bound {bound_ms:.5f} ms (3 x {flops} flops "
        f"at the TF32 rate), {f32_rate_ms:.5f} ms at the f32 rate; K5 "
        f"reaches {bound_ms / ms:.4f} of its bound")
    return dict(launches=launches[attn.F32_WIDE_ROUTE], max_abs_err=err,
                ms=ms,
                plain_ms=plain_ms, library_ms=sdpa_ms, bound_ms=bound_ms,
                bound_by=bound_by, bound_f32_rate_ms=f32_rate_ms)


def check_f32_wide(torch, attn) -> None:
    """Every instance of the wide f32 route against the plain version
    (:func:`check_hop`): G = 5 (Dv 150, D not a multiple of 8), 6 (D 64,
    Dv 180: D <= 128 < Dv), 7 (D 200, Dv 40: Dv <= 128 < D) and 8 (Dv 256,
    16-key tiles; the others take 32-key tiles); ragged and causal at
    G = 7; wholly masked rows and a hop whose two 64-row query tiles are
    each cut into many pieces merged in the launch, at G = 8."""
    f32 = torch.float32
    check_hop(torch, attn, "Dv 150", 1000, 777, 150, 150, f32, False,
              (0, 0), "mid", 30)
    check_hop(torch, attn, "G 6 D 64", 300, 500, 64, 180, f32, True,
              (200, 0), "mid", 36)
    check_hop(torch, attn, "G 7 Dv 40", 300, 500, 200, 40, f32, False,
              (0, 0), "initial", 37)
    check_hop(torch, attn, "ragged", 1000, 777, 200, 200, f32, True,
              (300, 0), "mid", 38)
    check_hop(torch, attn, "masked rows", 256, 256, 256, 256, f32, True,
              (0, 128), "mid", 39, masked_rows=128)
    sched = attn.hop_schedule(128, 4096, 4096, 0, True,
                              attn.tf32_tiles(256, 256)[1],
                              torch.cuda.get_device_properties(0)
                              .multi_processor_count,
                              attn.TF32_WIDE_BLOCK_Q)
    pieces = min(it[4] for it in sched.items)
    if pieces < 3:
        raise RuntimeError("the wide split case cut a query tile into fewer "
                           "than 3 pieces")
    check_hop(torch, attn, f"split ({pieces}+ pieces a tile)", 128, 4096,
              256, 256, f32, True, (4096, 0), "mid", 43)
    check_hop(torch, attn, "Dv 256", 1000, 777, 256, 256, f32, True,
              (300, 0), "mid", 32)


def check_graph_replay(torch, attn) -> None:
    """K5's work list outlives a CUDA graph that captured it: capture one
    hop (a wide f32 one and a bf16 one), call 70 hops of other offsets
    (each a work list of its own), allocate blocks of the captured table's
    own size filled with -1 (were the table freed, the caching allocator
    would hand its block to one of them), replay the graph and compare
    its output with an eager call of the same hop, bit for bit."""
    for label, dim, dtype, seed in (("f32-wide", 256, torch.float32, 44),
                                    ("bf16", 128, torch.bfloat16, 45)):
        bq, bk = (attn.tf32_tiles(dim, dim) if dtype == torch.float32 else
                  (attn.SM90_BLOCK_Q, attn.sm90_tiles(dim, dim)[1]))
        ops = hop_operands(torch, attn, 300, 500, dim, dim, dtype, "mid",
                           seed)
        scale = 1.0 / float(np.sqrt(dim))

        def hop(q_off=400):
            return attn.flash_hop_update_cuda(*ops, q_off, 0, scale, True)

        hop()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            hop()
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            captured = hop()
        cached = len(attn._SCHEDULES)
        table = attn._device_schedule(ops[0].device, 300, 500, 400, 0, True,
                                      bk, bq)[0]
        n_ints, table_ptr = table.numel(), table.data_ptr()
        del table
        if len(attn._SCHEDULES) != cached:
            raise RuntimeError("the graph check did not find the captured "
                               "hop's work list")
        for i in range(70):
            hop(1000 + 7 * i)
        torch.cuda.synchronize()
        junk = [torch.full((n_ints,), -1, dtype=torch.int32, device="cuda")
                for _ in range(4000)]
        reused = any(t.data_ptr() == table_ptr for t in junk)
        graph.replay()
        torch.cuda.synchronize()
        want = hop()
        torch.cuda.synchronize()
        diff = max(float((g - w).abs().max()) for g, w in zip(captured, want))
        log(f"[attention] graph replay ({label}, {attn.route(dtype, dim, dim)}"
            f"): captured one hop with {cached} work lists cached, called 70 "
            f"other hops ({len(attn._SCHEDULES)} cached), allocated "
            f"{len(junk)} blocks of {n_ints} int32 = -1 (one at the captured "
            f"table's address: {reused}); replay vs eager max abs diff "
            f"{diff}")
        if diff != 0.0 or not all(bool(torch.isfinite(t).all())
                                  for t in captured):
            raise RuntimeError(f"a replayed {label} hop disagrees with the "
                               "eager call: its work list was not kept")
        del junk, graph, captured


def check_split(torch, attn, seed) -> dict:
    """A bf16 hop whose query tiles are each cut into at least 3 pieces,
    merged in the launch: 256 query rows (2 tiles) after a 4096-key chunk
    wholly in their past (offsets (4096, 0), causal), a mid-stream
    carry."""
    sched = attn.hop_schedule(256, 4096, 4096, 0, True,
                              attn.sm90_tiles(ATTN_D, ATTN_D)[1],
                              torch.cuda.get_device_properties(0)
                              .multi_processor_count)
    pieces = min(it[4] for it in sched.items)
    log(f"[attention] split case: {len(sched.items)} items on "
        f"{sched.n_cta} CTAs, at least {pieces} pieces per query tile")
    if pieces < 3:
        raise RuntimeError("the split case cut a query tile into fewer than "
                           "3 pieces")
    return check_hop(torch, attn, "split", 256, 4096, ATTN_D, ATTN_D,
                     torch.bfloat16, True, (4096, 0), "mid", seed)


def attention_phase(torch, rate: float, name: str):
    """Phase 6: K5's routes against their plain version, their times beside
    SDPA and their bounds, the bf16 route's main run, the gradient check
    and the training demo. Returns the ``kernels`` entries of the two
    routes."""
    import torch.nn.functional as F

    from gossipy_tpu_torch.examples import demo_ring_attention as demo
    from gossipy_tpu_torch.ops import attention as attn

    bf16, bf16_route = torch.bfloat16, attn.BF16_ROUTE
    f32_route, wide_route = attn.F32_ROUTE, attn.F32_WIDE_ROUTE
    s_len, dim = ATTN_S, ATTN_D
    split = check_tf32_split(torch, attn, rate)
    bench = check_hop(torch, attn, "bench", s_len, s_len, dim, dim, bf16,
                      True, (0, 0), "initial", 21)
    check_hop(torch, attn, "bench-f32", s_len, s_len, dim, dim,
              torch.float32, True, (0, 0), "initial", 22)
    for seed, offs in ((23, (s_len, 0)), (24, (4096, 2048))):
        check_hop(torch, attn, f"mid-stream {offs}", s_len, s_len, dim, dim,
                  bf16, True, offs, "mid", seed)
    for seed, (causal, offs) in enumerate(((False, (0, 0)),
                                           (True, (300, 0))), start=25):
        for dtype in (torch.float32, bf16):
            check_hop(torch, attn, "ragged", 1000, 777, 72, 72, dtype,
                      causal, offs, "mid", seed)
    for dtype in (torch.float32, bf16):
        check_hop(torch, attn, "masked rows", 256, 256, dim, dim, dtype,
                  True, (0, 128), "mid", 27, masked_rows=128)
    check_split(torch, attn, 34)
    # Every instance of each route: the bf16 route's 64-column groups
    # G = 1-4 (128-key tiles up to G = 2, 64-key tiles above: D = 32, 150
    # and 256 here), the 3xTF32 route's 32-column groups G = 1-4 (D = Dv =
    # 32 the demo's own shape, 72 ragged above, 128 the bench cases), the
    # wide f32 route's G = 5-8 (check_f32_wide).
    check_hop(torch, attn, "G 2", 300, 200, 64, 40, torch.float32, True,
              (100, 0), "mid", 35)
    for seed, dtype in enumerate((torch.float32, bf16), start=28):
        check_hop(torch, attn, "demo shape", 256, 256, 32, 32, dtype, False,
                  (0, 0), "initial", seed)
    check_hop(torch, attn, "Dv 150", 1000, 777, 150, 150, bf16, False,
              (0, 0), "mid", 31)
    check_hop(torch, attn, "Dv 256", 1000, 777, 256, 256, bf16, True,
              (300, 0), "mid", 33)
    check_f32_wide(torch, attn)
    check_graph_replay(torch, attn)

    # The bf16 route's main run: flash_attention at the bench shape, as the
    # JAX bench calls it, with the launches counted; then its device time
    # beside the plain version and SDPA, which computes the same function.
    q, k, v = hop_operands(torch, attn, s_len, s_len, dim, dim, bf16,
                           "initial", 21)[:3]
    attn.LAUNCHES.clear()
    outs = [attn.flash_attention(q, k, v, causal=True) for _ in range(3)]
    torch.cuda.synchronize()
    main_launches = attn.LAUNCHES[bf16_route]
    if main_launches != 3 or attn.LAUNCHES[f32_route] or not all(
            o.shape == (s_len, dim) and o.dtype == bf16
            and bool(torch.isfinite(o).all()) for o in outs):
        raise RuntimeError(f"the bf16 route's main run launched "
                           f"{dict(attn.LAUNCHES)} for 3 calls, or its "
                           "output is not finite [S, D] bf16")
    del outs
    fa_ms = time_ms(torch, lambda: attn.flash_attention(q, k, v, causal=True))
    fa_plain_ms = time_ms(torch, lambda: attn.flash_attention_reference(
        q, k, v, causal=True))
    q4, k4, v4 = (t[None, None] for t in (q, k, v))
    sdpa_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True))
    sdpa = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)[0, 0]
    fa = attn.flash_attention(q, k, v, causal=True)
    sdpa_diff = float((fa.float() - sdpa.float()).abs().max())
    # Least work at the bf16 tensor-core rate (a bf16 product is exact in
    # f32).
    bound_ms, bound_by, nbytes, flops = attention_bound(
        rate, tensor_rate(name), s_len, dim, True, 2)
    f32_core_ms = flops / FP32_FLOPS * 1e3
    log(f"[attention] bench shape S={s_len} D=Dv={dim} bf16 causal, main "
        f"run: {main_launches} launches of {bf16_route} in 3 calls; "
        f"flash_attention (K5) {fa_ms:.5f} ms, through the plain hop "
        f"{fa_plain_ms:.5f} ms, SDPA {sdpa_ms:.5f} ms (K5 output vs SDPA: "
        f"max abs diff {sdpa_diff:.3e}); bound {bound_ms:.5f} ms ({nbytes} "
        f"bytes, {flops} flops, bound by {bound_by}; {f32_core_ms:.5f} ms "
        f"at the f32 CUDA-core rate); K5 reaches {bound_ms / fa_ms:.4f} of "
        f"its bound")
    del q, k, v, q4, k4, v4, sdpa, fa
    torch.cuda.empty_cache()
    f32 = f32_route_times(torch, attn, rate, name)
    wide = f32_wide_run(torch, attn, rate, name)

    # The gradient check, at the bench shape in f32.
    q, k, v = hop_operands(torch, attn, s_len, s_len, dim, dim, bf16,
                           "initial", 21)[:3]
    attention_parity(torch, attn, q, k, v)
    del q, k, v
    torch.cuda.empty_cache()

    # The training demo at its defaults (f32), K5 once per step.
    attn.LAUNCHES.clear()
    t0 = time.perf_counter()
    rec = demo.run(device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, demo_launches, split_launches = (
        attn.LAUNCHES[attn.KERNEL], attn.LAUNCHES[f32_route],
        attn.LAUNCHES[attn.SPLIT_KERNEL])
    log(f"[attention] demo at its defaults (S=256, D=32, 60 adam steps): "
        f"{json.dumps(rec)}; {wall:.3f} s; K5 launches {launches} "
        f"({demo_launches} of {f32_route}, {attn.LAUNCHES[wide_route]} of "
        f"{wide_route}), {split_launches} of {attn.SPLIT_KERNEL}")
    if not rec["learned"] or launches != 60 or demo_launches != 60 \
            or split_launches != 60 or not (
            np.isfinite(rec["loss_first"]) and np.isfinite(rec["loss_last"])):
        raise RuntimeError("the demo did not learn, or K5's 3xTF32 route and "
                           "its pre-pass did not launch once per step")

    # 3 training steps at the bench width in f32, with K5 and with the
    # plain version: the same losses within 1e-4 relative.
    start, x, tgt = bench_task(torch, demo)
    lk, _ = demo.train(start, x, tgt, 3, attention=attn.flash_attention)
    lp, _ = demo.train(start, x, tgt, 3,
                       attention=attn.flash_attention_reference)
    rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    log(f"[attention] 3 steps at S={s_len} D={dim} f32: losses with K5 {lk}, "
        f"with the plain version {lp}; max rel diff {rel:.3e}")
    if rel > 1e-4 or not all(np.isfinite(lk)):
        raise RuntimeError("training losses with K5 and with the plain "
                           "version disagree")
    replaces = "gossipy_tpu/ops/attention.py:77"
    return [{"name": bf16_route, "route": "cuda",
             "source": "gossipy_tpu_torch/csrc/flash_hop_sm90.cu",
             "replaces": replaces, "launches": main_launches,
             "max_abs_err": bench["max_abs_err"], "ms": fa_ms,
             "plain_ms": fa_plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": sdpa_ms},
            {"name": f32_route, "route": "cuda",
             "source": "gossipy_tpu_torch/csrc/flash_hop_tf32.cu",
             "replaces": replaces, "launches": demo_launches,
             "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
             "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
             "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
             "bound_f32_rate_ms": f32["bound_f32_rate_ms"],
             "library": f32["sdpa_backend"]},
            {"name": attn.SPLIT_KERNEL, "route": "cuda",
             "source": "gossipy_tpu_torch/csrc/flash_hop_tf32.cu",
             "replaces": replaces, "launches": split_launches, **split},
            {"name": wide_route, "route": "cuda",
             "source": "gossipy_tpu_torch/csrc/flash_hop_tf32.cu",
             "replaces": replaces, "launches": wide["launches"],
             "max_abs_err": wide["max_abs_err"], "ms": wide["ms"],
             "plain_ms": wide["plain_ms"], "bound_ms": wide["bound_ms"],
             "bound_by": wide["bound_by"], "library_ms": wide["library_ms"],
             "bound_f32_rate_ms": wide["bound_f32_rate_ms"]}]


def f32_wide_times(torch, attn, rate, name) -> None:
    """The wide f32 route at S = 8192, D = Dv = 256, f32, non-causal and
    causal: ``flash_attention`` (pre-pass included) beside SDPA in f32 and
    the bound at the TF32 rate for three products."""
    import torch.nn.functional as F
    tf32_rate = tensor_rate(name) * TF32_PER_BF16
    q, k, v = hop_operands(torch, attn, ATTN_S, ATTN_S, 256, 256,
                           torch.float32, "initial", 46)[:3]
    q4, k4, v4 = (t[None, None] for t in (q, k, v))
    for causal in (False, True):
        ms = time_ms(torch, lambda: attn.flash_attention(q, k, v,
                                                         causal=causal),
                     iters=10)
        sdpa_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal), iters=10)
        bound_ms = attention_bound(rate, tf32_rate / 3, ATTN_S, 256, causal,
                                   4)[0]
        log(f"[diagnostics] wide f32 S={ATTN_S} D=Dv=256 causal={causal}: "
            f"flash_attention ({attn.route(torch.float32, 256, 256)}) "
            f"{ms:.5f} ms, SDPA f32 {sdpa_ms:.5f} ms; bound {bound_ms:.5f} ms,"
            f" K5 reaches {bound_ms / ms:.4f} of it")


def bench_task(torch, demo):
    """The demo's task and initial params at the bench width (S = 8192,
    D = 128, f32) on the card: ``(params, x, target)``."""
    x_np, tgt_np, rng = demo.make_task(ATTN_S, ATTN_D, 5)
    start = demo.params_from_numpy(demo.init_params(ATTN_D, rng), "cuda")
    return start, torch.from_numpy(x_np).cuda(), torch.from_numpy(tgt_np).cuda()


def attention_diagnostics(torch) -> None:
    """Where K5's time goes, at the bench shape; not part of the smoke run.
    Run on the card after :func:`attention_phase` has held K5 to its plain
    version (``python3 -c "import torch, chip_smoke as cs;
    cs.attention_diagnostics(torch)"``). Prints the device time of the bare
    bf16 hop (K5 and plain), of causal and non-causal ``flash_attention``
    with the bf16 route and SDPA, and their non-causal/causal ratios (twice
    the pairs: a balanced causal schedule takes about half the non-causal
    time); the 3xTF32 route at the training shape beside SDPA in f32, its
    pre-pass alone and its bare hop (causal and not); the wide f32 route at
    S = 8192, D = 256 beside SDPA in f32 (:func:`f32_wide_times`); the
    host-clock time and peak memory of 3
    training steps at S = 8192, D = 128, f32, in turns plain, K5, K5,
    plain (so neither side alone pays the first use of the backward's
    shapes); and one profiled step with K5."""
    import torch.nn.functional as F

    from gossipy_tpu_torch.examples import demo_ring_attention as demo
    from gossipy_tpu_torch.ops import attention as attn

    torch.backends.cuda.matmul.allow_tf32 = False
    s_len, dim = ATTN_S, ATTN_D
    name = torch.cuda.get_device_name(0)
    log(f"[diagnostics] {nvidia_smi_line()}")
    q, k, v, m, l, acc = hop_operands(torch, attn, s_len, s_len, dim, dim,
                                      torch.bfloat16, "initial", 21)
    scale = 1.0 / float(np.sqrt(dim))
    hop_ms = time_ms(torch, lambda: attn.flash_hop_update_cuda(
        q, k, v, m, l, acc, 0, 0, scale, True))
    hop_plain_ms = time_ms(torch, lambda: attn.flash_hop_update_reference(
        q, k, v, m, l, acc, 0, 0, scale, True))
    q4, k4, v4 = (t[None, None] for t in (q, k, v))
    times = {}
    for causal in (True, False):
        times[causal] = (
            time_ms(torch, lambda: attn.flash_attention(q, k, v,
                                                        causal=causal)),
            time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal)))
    (fa_c, sd_c), (fa_n, sd_n) = times[True], times[False]
    bound_n = attention_bound(memory_rate(name), tensor_rate(name), s_len,
                              dim, False, 2)[0]
    log(f"[diagnostics] S={s_len} D=Dv={dim} bf16: causal hop alone, K5 "
        f"{hop_ms:.5f} ms, plain {hop_plain_ms:.5f} ms; flash_attention "
        f"(K5 {attn.BF16_ROUTE}) causal {fa_c:.5f} ms, "
        f"non-causal {fa_n:.5f} ms (bound {bound_n:.5f}, reaches "
        f"{bound_n / fa_n:.4f}), non-causal/causal {fa_n / fa_c:.3f}; SDPA "
        f"causal {sd_c:.5f} ms, non-causal {sd_n:.5f} ms, ratio "
        f"{sd_n / sd_c:.3f}")
    del q, k, v, m, l, acc, q4, k4, v4
    torch.cuda.empty_cache()
    f32_route_times(torch, attn, memory_rate(name), name)
    # The 3xTF32 route's parts at the training shape: the pre-pass alone,
    # the bare hop (pre-pass and hop kernel, no carry fills or division).
    q, k, v, m, l, acc = hop_operands(torch, attn, s_len, s_len, dim, dim,
                                      torch.float32, "initial", 40)
    split_ms = time_ms(torch, lambda: attn.tf32_split(q, k, v))
    hop32_ms = time_ms(torch, lambda: attn.flash_hop_update_cuda(
        q, k, v, m, l, acc, 0, 0, scale, False), iters=10)
    hop32_c_ms = time_ms(torch, lambda: attn.flash_hop_update_cuda(
        q, k, v, m, l, acc, 0, 0, scale, True), iters=10)
    log(f"[diagnostics] S={s_len} D=Dv={dim} f32, {attn.F32_ROUTE}: "
        f"pre-pass {split_ms:.5f} ms; hop (pre-pass included) non-causal "
        f"{hop32_ms:.5f} ms, causal {hop32_c_ms:.5f} ms")
    del q, k, v, m, l, acc
    torch.cuda.empty_cache()
    f32_wide_times(torch, attn, memory_rate(name), name)

    start, x, tgt = bench_task(torch, demo)

    def steps(attention):
        """3 steps; host-clock ms per step and peak device GiB."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        demo.train(start, x, tgt, 3, attention=attention)
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) / 3 * 1e3,
                torch.cuda.max_memory_allocated() / 2 ** 30)

    runs = [steps(f) for f in (attn.flash_attention_reference,
                               attn.flash_attention, attn.flash_attention,
                               attn.flash_attention_reference)]
    log(f"[diagnostics] 3 steps at S={s_len} D={dim} f32, host-clock ms/step "
        f"(forward, backward and adam) in turns plain, K5, K5, plain: "
        f"{', '.join(f'{r[0]:.3f}' for r in runs)}; peak memory "
        f"{', '.join(f'{r[1]:.2f}' for r in runs)} GiB")
    profile(torch, lambda: demo.train(start, x, tgt, 1),
            f"one training step with K5 at S={s_len} D={dim} f32")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from gossipy_tpu_torch import ops
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
    sources = ops.SOURCES
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
    profile(torch, lambda: sim._round(state), "one round without eval")
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

    # 6. attention: K5, its gradient and the training demo
    k5 = attention_phase(torch, rate, name)

    # 7. the north-star configuration and the examples' network model
    ns_paths = northstar_phase(torch, merge, rate)

    # 8. the 100-node CIFAR-10 flagship
    flag_paths, at_flagship = flagship_phase(torch, merge, rate)
    for key, by_path in flag_paths.items():
        ns_paths.setdefault(key, {}).update(by_path)

    # 9. the four paper examples on the vanilla simulator
    paper_paths, at_ormandi = papers_phase(torch, merge, rate)
    for key, by_path in paper_paths.items():
        ns_paths.setdefault(key, {}).update(by_path)

    # 10. the variant simulators and the four examples they carry
    t0 = time.perf_counter()
    variant_paths, at_variants = variants_phase(torch, merge, rate)
    for key, by_path in variant_paths.items():
        ns_paths.setdefault(key, {}).update(by_path)
    log(f"[variants] phase 10 took {time.perf_counter() - t0:.1f} s")

    def entry(kernel, wire, source, replaces, nums, launched):
        return {"name": kernel if wire is None else f"{kernel}[{wire}]",
                "route": "cuda", "source": f"gossipy_tpu_torch/csrc/{source}",
                "replaces": f"gossipy_tpu/ops/merge.py:{replaces}",
                "launches": launched, "max_abs_err": nums["max_abs_err"],
                "ms": nums["ms"], "plain_ms": nums["plain_ms"],
                "bound_ms": nums["bound_ms"], "bound_by": nums["bound_by"],
                "library_ms": None,
                "launches_by_path": ns_paths.get((kernel, wire or "float32"),
                                                 {})}

    kernels = [entry(merge.KERNEL, None, "gather_merge_multi.cu", 76, k1,
                     launches)]
    kernels[0]["at_flagship_shape"] = at_flagship[("multi", "float32")]
    kernels[0]["at_ormandi_shape"] = at_ormandi
    kernels[0]["at_giaretta_shape"] = at_variants["giaretta"]
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
        if (slots, wire) in at_flagship:
            kernels[-1]["at_flagship_shape"] = at_flagship[(slots, wire)]
        if slots == "single" and ("tokenized", wire) in at_variants:
            kernels[-1]["at_tokenized_shape"] = at_variants[("tokenized",
                                                             wire)]
    kernels.extend(k5)
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
