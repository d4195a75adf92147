"""Population-scale gossip: tens of thousands of nodes on a sparse topology.

Twin of the JAX package's scale rows (``bench.py --scale`` and
``--scale-all2all``, and the rungs of ``scripts/scale_ladder.py``), built
through the port's entry points. The data is a synthetic spambase-shaped
set: 57 standard-normal features, a linear label, 4 samples a node, the
global eval set capped at 2048 samples. ``LogisticRegression(57, 2)``
under SGD 0.1, batch 4, one local epoch, MERGE_UPDATE, on
``SparseTopology.random_regular(N, 20, seed=42)`` (CSR neighbour lists,
O(E) memory: no ``[N, N]`` anywhere):

- the vanilla row: ``SGDHandler``, PUSH, ``delta=100``, a 1% sampled
  global eval on the last round only, an fp32 ring, the default deliver
  path (the single-pass fused deliver, K1 once a round with messages);
- the all-to-all row (``--all2all``): ``WeightedSGDHandler`` under
  ``uniform_mixing(topology)``, the O(E) sparse mixing in
  ``--sparse-mix-form`` (``auto`` is ``segment``), 50 rounds by default.

The metric is the engine's throughput, not the learning curve. It prints
one JSON line: rounds/s of the timed rounds (after a warm-up round),
the final global accuracy, the topology build seconds and the memory
budget (``memory_budget()``, and the card's peak allocation). It runs on
the card; ``--device cpu`` runs on the host:

    python3 -m gossipy_tpu_torch.examples.scale --nodes 50000
    python3 -m gossipy_tpu_torch.examples.scale --all2all --nodes 50000
    python3 -m gossipy_tpu_torch.examples.scale --nodes 100000 --rounds 20
    python3 -m gossipy_tpu_torch.examples.scale --device cpu --nodes 64 \\
        --rounds 5
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from gossipy_tpu_torch import resolve_device, set_seed
from gossipy_tpu_torch.core import AntiEntropyProtocol, CreateModelMode, \
    SparseTopology, uniform_mixing
from gossipy_tpu_torch.data import ClassificationDataHandler, DataDispatcher
from gossipy_tpu_torch.handlers import SGDHandler, WeightedSGDHandler, \
    losses
from gossipy_tpu_torch.models import LogisticRegression
from gossipy_tpu_torch.optim import sgd
from gossipy_tpu_torch.random import TorchDraws
from gossipy_tpu_torch.simulation import All2AllGossipSimulator, \
    GossipSimulator

FEATURES = 57
DEGREE = 20
ROUND_LEN = 100
HISTORY_DTYPE = "float32"
EVAL_CAP = 2048
WARMUP_ROUNDS = 1
# The node counts of scripts/scale_ladder.py's DEFAULT_RUNGS.
LADDER = (1_000, 2_000, 5_000, 10_000, 20_000, 50_000, 100_000)


def scale_data(n: int) -> dict:
    """The stacked data of ``n`` nodes: ``4 n`` samples of the synthetic
    set (``default_rng(42)``), the eval split capped at ``EVAL_CAP``
    samples (a cap, not a floor: a small run keeps 20%)."""
    rng = np.random.default_rng(42)
    w = rng.normal(size=FEATURES)
    X = rng.normal(size=(4 * n, FEATURES)).astype(np.float32)
    y = (X @ w > 0).astype(np.int64)
    eval_cap = min(EVAL_CAP, int(0.2 * len(X)))
    disp = DataDispatcher(
        ClassificationDataHandler(X, y, test_size=eval_cap / len(X)),
        n=n, eval_on_user=False)
    return disp.stacked()


def scale_handler(weighted: bool = False):
    cls = WeightedSGDHandler if weighted else SGDHandler
    return cls(LogisticRegression(FEATURES, 2), losses.cross_entropy,
               optimizer=sgd(0.1), local_epochs=1, batch_size=4,
               n_classes=2, input_shape=(FEATURES,),
               create_model_mode=CreateModelMode.MERGE_UPDATE)


def build_vanilla(n: int, rounds: int, topology: SparseTopology,
                  data=None, draws=None, device=None,
                  **kw) -> GossipSimulator:
    """The vanilla row's simulator over ``topology`` (``kw`` goes to the
    simulator: a deliver path, telemetry)."""
    return GossipSimulator(
        scale_handler(), topology, scale_data(n) if data is None else data,
        delta=ROUND_LEN, protocol=AntiEntropyProtocol.PUSH,
        sampling_eval=0.01, eval_every=rounds, history_dtype=HISTORY_DTYPE,
        draws=draws if draws is not None else TorchDraws(42),
        device=device, **kw)


def build_all2all(n: int, rounds: int, topology: SparseTopology,
                  data=None, draws=None, device=None,
                  sparse_mix_form: str = "auto",
                  **kw) -> All2AllGossipSimulator:
    """The all-to-all row's simulator: uniform O(E) mixing weights over
    ``topology``."""
    return All2AllGossipSimulator(
        scale_handler(weighted=True), topology,
        scale_data(n) if data is None else data, delta=ROUND_LEN,
        mixing=uniform_mixing(topology), sparse_mix_form=sparse_mix_form,
        sampling_eval=0.01, eval_every=rounds,
        draws=draws if draws is not None else TorchDraws(42),
        device=device, **kw)


def run(n: int, rounds: int, all2all: bool = False, device=None,
        seed: int = 42, sparse_mix_form: str = "auto") -> dict:
    """Build the row at ``n`` nodes, run ``WARMUP_ROUNDS`` rounds, then
    time ``rounds`` rounds (the card synchronised before the clock
    stops)."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    topology = SparseTopology.random_regular(n, min(DEGREE, n - 1),
                                             seed=42)
    build_s = time.perf_counter() - t0
    total = WARMUP_ROUNDS + rounds
    if all2all:
        sim = build_all2all(n, total, topology, device=dev,
                            sparse_mix_form=sparse_mix_form)
    else:
        sim = build_vanilla(n, total, topology, device=dev)
    budget = sim.memory_budget()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    state = sim.init_nodes(set_seed(seed))
    state, _ = sim.start(state, n_rounds=WARMUP_ROUNDS)
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, report = sim.start(state, n_rounds=rounds)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acc = report.curves(local=False)["accuracy"][-1]
    out = {"row": "all2all" if all2all else "vanilla", "nodes": n,
           "degree": min(DEGREE, n - 1), "rounds": rounds,
           "rounds_per_s": rounds / wall,
           "final_global_accuracy": float(acc),
           "topology_build_seconds": build_s,
           "sent_messages": report.sent_messages,
           "memory_budget_bytes": budget["total_bytes"]}
    if all2all:
        out["sparse_mix_form"] = ("padded" if sim._sparse_padded
                                  else "segment")
    else:
        out["fused_merge"] = sim.fused_merge
    if cuda:
        out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nodes", type=int, default=50_000,
                   help="population (the ladder's rungs: "
                        + ", ".join(str(x) for x in LADDER) + ")")
    p.add_argument("--rounds", type=int, default=None,
                   help="timed rounds (100, or 50 with --all2all)")
    p.add_argument("--all2all", action="store_true")
    p.add_argument("--sparse-mix-form", default="auto",
                   choices=("auto", "padded", "segment"))
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    rounds = args.rounds or (50 if args.all2all else 100)
    out = run(args.nodes, rounds, args.all2all, args.device, args.seed,
              args.sparse_mix_form)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
