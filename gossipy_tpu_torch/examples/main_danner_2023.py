"""Danner and Jelasity 2023: gossip learning with limited model merging.

Twin of the JAX package's ``examples/main_danner_2023.py``, built through
the port's entry points: the spambase stand-in split 90/10, 100 nodes on
``random_regular(100, 20, seed=42)``, ``LogisticRegression(57, 2)``
under ``chain(add_decayed_weights(1e-3), sgd(1.0))``, batch 32,
cross-entropy, ``LimitedMergeSGDHandler(age_diff_threshold=1)`` under
MERGE_UPDATE, sync PUSH with ``UniformDelay(0, 10)``, 20% online, 10%
drops, a 10% sampled evaluation, 1000 rounds. The limited merge is not a
uniform average: the plain deliver path. It runs on the card;
``--device cpu`` runs on the host:

    python3 -m gossipy_tpu_torch.examples.main_danner_2023
    python3 -m gossipy_tpu_torch.examples.main_danner_2023 \\
        --device cpu --nodes 16 --rounds 10
"""

from __future__ import annotations

import warnings

from gossipy_tpu_torch import set_seed
from gossipy_tpu_torch.core import AntiEntropyProtocol, CreateModelMode, \
    Topology, UniformDelay
from gossipy_tpu_torch.data import ClassificationDataHandler, \
    DataDispatcher, load_classification_dataset
from gossipy_tpu_torch.examples._common import finish, make_parser
from gossipy_tpu_torch.handlers import LimitedMergeSGDHandler, losses
from gossipy_tpu_torch.models import LogisticRegression
from gossipy_tpu_torch.optim import add_decayed_weights, chain, sgd
from gossipy_tpu_torch.random import TorchDraws
from gossipy_tpu_torch.simulation import GossipSimulator

DEGREE = 20


def danner_data(nodes: int = 100, seed: int = 42, sets=None) -> tuple:
    """``(stacked, dim)``: the spambase stand-in (or ``sets = (X, y)``)
    split 90/10 with ``seed`` over ``nodes`` uniform shards; the 10% is
    the global eval set."""
    if sets is None:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # the offline stand-in's note
            sets = load_classification_dataset("spambase")
    X, y = sets
    dh = ClassificationDataHandler(X, y, test_size=0.1, seed=seed)
    return (DataDispatcher(dh, n=nodes, eval_on_user=False).stacked(),
            dh.size(1))


def danner_handler(dim: int) -> LimitedMergeSGDHandler:
    """LogReg(dim, 2) under weight decay 1e-3 and SGD 1.0, batch 32, one
    local epoch, limited merging with threshold 1, MERGE_UPDATE."""
    return LimitedMergeSGDHandler(
        LogisticRegression(dim, 2), losses.cross_entropy,
        optimizer=chain(add_decayed_weights(1e-3), sgd(1.0)),
        local_epochs=1, batch_size=32, n_classes=2, input_shape=(dim,),
        age_diff_threshold=1,
        create_model_mode=CreateModelMode.MERGE_UPDATE)


def danner_sim(stacked, dim: int, seed: int = 42, draws=None,
               device=None, **kw) -> GossipSimulator:
    """The Danner simulator over ``stacked``: ``random_regular(n, min(20,
    n - 1), seed=42)``, sync PUSH, ``UniformDelay(0, 10)``, online 0.2,
    drop 0.1, ``sampling_eval=0.1``; draws from ``TorchDraws(seed)``
    unless ``draws`` is given; ``kw`` goes to the simulator."""
    n = int(stacked["mtr"].shape[0])
    return GossipSimulator(
        danner_handler(dim),
        Topology.random_regular(n, min(DEGREE, n - 1), seed=42), stacked,
        delta=100, protocol=AntiEntropyProtocol.PUSH,
        delay=UniformDelay(0, 10), online_prob=0.2, drop_prob=0.1,
        sampling_eval=0.1, sync=True,
        draws=draws if draws is not None else TorchDraws(seed),
        device=device, **kw)


def main(argv=None) -> dict:
    args = make_parser(__doc__, rounds=1000, nodes=100).parse_args(argv)
    generator = set_seed(args.seed)
    stacked, dim = danner_data(args.nodes, args.seed)
    sim = danner_sim(stacked, dim, args.seed, device=args.device)
    state = sim.init_nodes(generator)
    state, report = sim.start(state, n_rounds=args.rounds)
    return finish(report, args, local=False)


if __name__ == "__main__":
    main()
