"""The 100-node CIFAR-10 flagship: CIFAR10Net gossip learning at 100 nodes.

Twin of the JAX package's ``examples/main_cifar10_100nodes.py``, built
through the port's entry points: CIFAR-10 (the synthetic stand-in of
:func:`~gossipy_tpu_torch.data.get_CIFAR10`) normalised by the training
set's statistics, a Dirichlet label skew across the nodes
(``label_dirichlet_skew(beta)``), ``CIFAR10Net`` under weight decay 1e-3
and SGD 0.05, batch 32, MERGE_UPDATE, PUSH gossip on
``random_regular(n, 20, seed=42)``, ``delta=100``, a 10% sampled
evaluation, sync nodes and a common initialisation.

``--bf16`` runs the forward and backward passes in bfloat16;
``--history-dtype bfloat16|int8`` stores the history ring in a quantized
wire format; ``--deliver`` picks the deliver path (``multi``, the port's
default, blends every live message in one launch of the multi-slot
gather-merge kernel); ``--probes``, ``--sentinels`` and ``--chaos`` (a
half/half partition over the middle third of the run) switch on the
gossip-dynamics probes, the numerics sentinels and the scheduled faults,
and the summary reports them. The JAX script's ``--plot`` is not here
(the card's machine has no matplotlib). It runs on the card; ``--device
cpu`` runs the plain versions on the host (use small ``--nodes`` and
``--subsample`` there):

    python3 -m gossipy_tpu_torch.examples.main_cifar10_100nodes --bf16
    python3 -m gossipy_tpu_torch.examples.main_cifar10_100nodes --bf16 \
        --history-dtype bfloat16 --probes --sentinels --chaos --rounds 10
    python3 -m gossipy_tpu_torch.examples.main_cifar10_100nodes \\
        --device cpu --nodes 8 --subsample 512 --rounds 2
"""

from __future__ import annotations

import argparse
import json
import time
import warnings

import numpy as np
import torch

from gossipy_tpu_torch import set_seed
from gossipy_tpu_torch.core import AntiEntropyProtocol, CreateModelMode, \
    Topology
from gossipy_tpu_torch.data import AssignmentHandler, \
    ClassificationDataHandler, DataDispatcher, get_CIFAR10
from gossipy_tpu_torch.examples._common import add_chaos_flag, \
    add_probes_flag, add_sentinels_flag, demo_chaos_config, \
    telemetry_summary
from gossipy_tpu_torch.handlers import SGDHandler, losses
from gossipy_tpu_torch.models import CIFAR10Net
from gossipy_tpu_torch.optim import add_decayed_weights, chain, sgd
from gossipy_tpu_torch.random import TorchDraws
from gossipy_tpu_torch.simulation import GossipSimulator

DELIVER = {"multi": "multi", "per_slot": "per_slot", "plain": False}
WEIGHT_DECAY = 1e-3
LEARNING_RATE = 0.05
BATCH_SIZE = 32
DEGREE = 20


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=100)
    p.add_argument("--nodes", type=int, default=100)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--subsample", type=int, default=0,
                   help="cap train/test sizes (0 = full 50k/10k)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 forward/backward")
    p.add_argument("--beta", type=float, default=0.5,
                   help="Dirichlet non-IID concentration")
    p.add_argument("--eval-every", type=int, default=1,
                   help="evaluate every n-th round")
    p.add_argument("--history-dtype", default="float32",
                   choices=("float32", "bfloat16", "int8"),
                   help="history ring wire format")
    p.add_argument("--deliver", default="multi", choices=tuple(DELIVER),
                   help="deliver path (multi: one multi-slot gather-merge "
                        "launch a round)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    add_probes_flag(p)
    add_sentinels_flag(p)
    add_chaos_flag(p)
    return p.parse_args(argv)


def flagship_data(n: int, subsample: int = 0, beta: float = 0.5,
                  seed: int = 42, sets=None) -> dict:
    """The stacked shards (numpy): CIFAR-10 (or ``sets``, ``((Xtr, ytr),
    (Xte, yte))``), the first ``subsample`` train rows and a fifth as many
    test rows when ``subsample`` is set, both normalised with the training
    set's mean and std, the train rows split by
    ``label_dirichlet_skew(beta)`` with ``seed``; the test set is the
    global evaluation set."""
    if sets is None:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # the synthetic stand-in's note
            sets = get_CIFAR10()
    (Xtr, ytr), (Xte, yte) = sets
    if subsample:
        Xtr, ytr = Xtr[:subsample], ytr[:subsample]
        Xte, yte = Xte[:subsample // 5 or 1], yte[:subsample // 5 or 1]
    mu, sd = Xtr.mean(), Xtr.std() + 1e-8
    Xtr = (Xtr - mu) / sd
    Xte = (Xte - mu) / sd
    dispatcher = DataDispatcher(
        ClassificationDataHandler(Xtr, ytr, Xte, yte), n=n,
        eval_on_user=False, assignment=AssignmentHandler.label_dirichlet_skew,
        beta=beta)
    dispatcher.assign(seed)
    return dispatcher.stacked()


def flagship_handler(bf16: bool = False) -> SGDHandler:
    """CIFAR10Net under ``chain(add_decayed_weights(1e-3), sgd(0.05))``,
    batch 32, one local epoch, MERGE_UPDATE; bfloat16 compute with
    ``bf16``."""
    return SGDHandler(
        CIFAR10Net(), losses.cross_entropy,
        optimizer=chain(add_decayed_weights(WEIGHT_DECAY),
                        sgd(LEARNING_RATE)),
        local_epochs=1, batch_size=BATCH_SIZE, n_classes=10,
        input_shape=(32, 32, 3),
        create_model_mode=CreateModelMode.MERGE_UPDATE,
        compute_dtype=torch.bfloat16 if bf16 else None)


def flagship_sim(stacked: dict, n: int, bf16: bool = False,
                 deliver: str = "multi", history_dtype: str = "float32",
                 eval_every: int = 1, seed: int = 42, draws=None,
                 device=None, **kw) -> GossipSimulator:
    """The flagship simulator over ``stacked`` (numpy, or tensors already
    on the device): PUSH on ``random_regular(n, min(20, n - 1),
    seed=42)``, ``delta=100``, a 10% sampled evaluation, sync nodes; draws
    from ``TorchDraws(seed)`` unless ``draws`` is given; ``kw`` (probes,
    sentinels, chaos) goes to the simulator."""
    return GossipSimulator(
        flagship_handler(bf16),
        Topology.random_regular(n, min(DEGREE, n - 1), seed=42,
                                backend="networkx"),
        stacked, delta=100, protocol=AntiEntropyProtocol.PUSH,
        sampling_eval=0.1, sync=True, eval_every=eval_every,
        fused_merge=DELIVER[deliver], history_dtype=history_dtype,
        draws=draws if draws is not None else TorchDraws(seed),
        device=device, **kw)


def main(argv=None) -> dict:
    args = parse_args(argv)
    generator = set_seed(args.seed)
    stacked = flagship_data(args.nodes, args.subsample, args.beta, args.seed)
    sim = flagship_sim(stacked, args.nodes, args.bf16, args.deliver,
                       args.history_dtype, args.eval_every, args.seed,
                       device=args.device, probes=args.probes,
                       sentinels=args.sentinels,
                       chaos=demo_chaos_config(args))
    budget = sim.memory_budget()
    print(f"[cifar10-100nodes] history ring ({args.history_dtype}): "
          f"{budget['history_ring_bytes'] / 2**20:.1f} MB "
          f"(depth {budget['history_depth']}, "
          f"{sim.wire_bytes_per_message():,} wire bytes/message); memory "
          f"budget {budget['total_bytes'] / 2**30:.3f} GiB on {sim.device}")
    # Common initialisation: averaging differently initialised CNNs
    # cancels features and 100-node runs stay at chance.
    state = sim.init_nodes(generator, common_init=True)
    t0 = time.perf_counter()
    state, report = sim.start(state, n_rounds=args.rounds)
    if sim.device.type == "cuda":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    print(f"[cifar10-100nodes] {args.rounds} rounds in {elapsed:.1f}s "
          f"({args.rounds / elapsed:.2f} r/s)")
    summary = {"rounds": args.rounds,
               "sent_messages": report.sent_messages,
               "failed_messages": report.failed_messages,
               "total_size": report.total_size,
               "final": {k: round(float(v[-1]), 4)
                         for k, v in report.curves(local=False).items()
                         if len(v) and np.isfinite(v[-1])}}
    summary.update(telemetry_summary(report, args))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
