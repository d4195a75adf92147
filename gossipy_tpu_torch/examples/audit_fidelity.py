"""Audit the bulk engine's fidelity divergences on your configuration.

Twin of the JAX package's ``examples/audit_fidelity.py``, built through
the port's entry points: the same small configuration (a synthetic
12-feature linearly separable set, ``random_regular(n, min(6, n - 1))``,
LogReg under SGD 0.2, batch 8, MERGE_UPDATE, PUSH, delta 20) runs
through the bulk engine and the sequential high-fidelity engine
(:class:`~gossipy_tpu_torch.simulation.SequentialGossipSimulator`: the
reference's per-tick semantics, in-round snapshots, same-tick token
reactions, per-message events) over a few seeds each, and the script
prints where the mean accuracy and send-count curves diverge. Run it
before trusting a bulk study of a new protocol configuration: where the
two engines agree, the bulk engine's rounds are safe at any scale.
``--tokenized`` audits the token-reaction path (``SimpleTokenAccount(C=2)``,
same tick against next round). It runs on the card; ``--device cpu``
runs the plain versions on the host:

    python3 -m gossipy_tpu_torch.examples.audit_fidelity
    python3 -m gossipy_tpu_torch.examples.audit_fidelity --tokenized \\
        --device cpu --nodes 8 --rounds 4 --seeds 2
"""

from __future__ import annotations

import json

import numpy as np
import torch

from gossipy_tpu_torch.core import AntiEntropyProtocol, CreateModelMode, \
    Topology
from gossipy_tpu_torch.data import ClassificationDataHandler, DataDispatcher
from gossipy_tpu_torch.examples._common import make_parser
from gossipy_tpu_torch.flow_control import SimpleTokenAccount
from gossipy_tpu_torch.handlers import SGDHandler, losses
from gossipy_tpu_torch.models import LogisticRegression
from gossipy_tpu_torch.random import TorchDraws
from gossipy_tpu_torch.simulation import GossipSimulator, \
    SequentialGossipSimulator, TokenizedGossipSimulator

DIM = 12
DELTA = 20


def audit_data(nodes: int, seed: int) -> tuple:
    """``(stacked, topology)``: 30 samples a node of a linearly separable
    ``DIM``-feature set, split 75/25 with ``seed`` (the 25% the global
    eval set), over ``random_regular(nodes, min(6, nodes - 1), seed)``."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(30 * nodes, DIM)).astype(np.float32)
    y = (X @ rng.normal(size=DIM) > 0).astype(np.int64)
    dh = ClassificationDataHandler(X, y, test_size=0.25, seed=seed)
    stacked = DataDispatcher(dh, n=nodes, eval_on_user=False).stacked()
    return stacked, Topology.random_regular(nodes, min(6, nodes - 1),
                                            seed=seed)


def audit_handler() -> SGDHandler:
    """LogReg under SGD 0.2, one local epoch, batch 8, MERGE_UPDATE."""
    return SGDHandler(LogisticRegression(DIM, 2), losses.cross_entropy,
                      learning_rate=0.2, local_epochs=1, batch_size=8,
                      n_classes=2, input_shape=(DIM,),
                      create_model_mode=CreateModelMode.MERGE_UPDATE)


def audit_sim(engine: str, stacked: dict, topo, tokenized: bool, seed: int,
              device=None):
    """The configuration's simulator in ``engine`` ("bulk" or
    "sequential"), drawing from ``TorchDraws(seed)``."""
    handler = audit_handler()
    kw = dict(delta=DELTA, protocol=AntiEntropyProtocol.PUSH,
              draws=TorchDraws(seed), device=device)
    account = {"token_account": SimpleTokenAccount(C=2)} if tokenized else {}
    if engine == "sequential":
        return SequentialGossipSimulator(handler, topo, stacked, **account,
                                         **kw)
    if tokenized:
        return TokenizedGossipSimulator(handler, topo, stacked, **account,
                                        **kw)
    return GossipSimulator(handler, topo, stacked, **kw)


def main(argv=None) -> dict:
    p = make_parser(__doc__, rounds=12, nodes=16, with_plot=False)
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--tokenized", action="store_true",
                   help="audit the token-reaction path (same-tick vs "
                        "next-round delivery)")
    args = p.parse_args(argv)

    stacked, topo = audit_data(args.nodes, args.seed)

    acc = {"bulk": [], "sequential": []}
    sent = {"bulk": [], "sequential": []}
    for engine in ("bulk", "sequential"):
        for s in range(args.seeds):
            seed = args.seed + s
            sim = audit_sim(engine, stacked, topo, args.tokenized, seed,
                            args.device)
            state = sim.init_nodes(torch.Generator().manual_seed(seed))
            _, rep = sim.start(state, n_rounds=args.rounds)
            acc[engine].append(rep.curves(local=False)["accuracy"])
            sent[engine].append(np.asarray(rep.sent_per_round, np.float64))

    acc_gap = np.abs(np.mean(acc["bulk"], 0) - np.mean(acc["sequential"], 0))
    sent_gap = np.abs(np.mean(sent["bulk"], 0)
                      - np.mean(sent["sequential"], 0))
    print("per-round mean accuracy gap:", np.round(acc_gap, 4).tolist())
    print("per-round mean sent-count gap:", np.round(sent_gap, 2).tolist())
    summary = {
        "rounds": args.rounds,
        "nodes": args.nodes,
        "seeds": args.seeds,
        "tokenized": bool(args.tokenized),
        "max_accuracy_gap": round(float(acc_gap.max()), 4),
        "tail_accuracy_gap": round(float(acc_gap[-1]), 4),
        "max_sent_gap": round(float(sent_gap.max()), 2),
        "final": {
            "accuracy_bulk": round(float(np.mean(acc["bulk"], 0)[-1]), 4),
            "accuracy_sequential": round(
                float(np.mean(acc["sequential"], 0)[-1]), 4),
        },
    }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
