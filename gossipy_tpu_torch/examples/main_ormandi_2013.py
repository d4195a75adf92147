"""Ormandi et al. 2013: vanilla gossip learning with Pegasos.

Twin of the JAX package's ``examples/main_ormandi_2013.py``, built through
the port's entry points: the spambase stand-in with ±1 labels split 90/10,
one node per training sample (4,141), ``PegasosHandler`` over ``AdaLine``
(lambda 0.01) under MERGE_UPDATE on a clique, async PUSH with
``UniformDelay(0, 10)``, 20% online, 10% drops, a 10% sampled
evaluation. Pegasos's merge is the uniform average, so the port's
default deliver is the single-pass fused one (one launch of the
multi-slot gather-merge kernel a round with messages), where the JAX
example takes the plain path. ``--repetitions`` runs the repetitions
one after another (``run_repetitions``). It runs on the card;
``--device cpu`` runs the plain versions on the host:

    python3 -m gossipy_tpu_torch.examples.main_ormandi_2013
    python3 -m gossipy_tpu_torch.examples.main_ormandi_2013 \\
        --device cpu --nodes 64 --rounds 10
"""

from __future__ import annotations

import warnings

import numpy as np

from gossipy_tpu_torch import set_seed
from gossipy_tpu_torch.core import AntiEntropyProtocol, CreateModelMode, \
    Topology, UniformDelay
from gossipy_tpu_torch.data import ClassificationDataHandler, \
    DataDispatcher, load_classification_dataset
from gossipy_tpu_torch.examples._common import add_repetitions_flag, \
    finish, make_parser
from gossipy_tpu_torch.handlers import PegasosHandler
from gossipy_tpu_torch.models import AdaLine
from gossipy_tpu_torch.random import TorchDraws
from gossipy_tpu_torch.simulation import GossipSimulator


def ormandi_data(nodes: int = 0, seed: int = 42, sets=None) -> tuple:
    """``(stacked, dim)``: the spambase stand-in (or ``sets = (X, y)``)
    with ±1 float labels, split 90/10 with ``seed``, one node per
    training sample unless ``nodes`` is set; the 10% is the global eval
    set."""
    if sets is None:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # the offline stand-in's note
            sets = load_classification_dataset("spambase")
    X, y = sets
    y = (2 * y - 1).astype(np.float32)
    dh = ClassificationDataHandler(X, y, test_size=0.1, seed=seed)
    n = nodes or dh.size()
    return DataDispatcher(dh, n=n, eval_on_user=False).stacked(), dh.size(1)


def ormandi_sim(stacked, dim: int, seed: int = 42, draws=None,
                device=None, **kw) -> GossipSimulator:
    """The Ormandi simulator over ``stacked``: Pegasos (lambda 0.01),
    MERGE_UPDATE, clique, async PUSH, ``UniformDelay(0, 10)``, online
    0.2, drop 0.1, ``sampling_eval=0.1``; draws from ``TorchDraws(seed)``
    unless ``draws`` is given; ``kw`` goes to the simulator."""
    n = int(stacked["mtr"].shape[0])
    handler = PegasosHandler(net=AdaLine(dim), learning_rate=0.01,
                             create_model_mode=CreateModelMode.MERGE_UPDATE)
    return GossipSimulator(
        handler, Topology.clique(n), stacked, delta=100,
        protocol=AntiEntropyProtocol.PUSH, delay=UniformDelay(0, 10),
        online_prob=0.2, drop_prob=0.1, sampling_eval=0.1, sync=False,
        draws=draws if draws is not None else TorchDraws(seed),
        device=device, **kw)


def main(argv=None) -> dict:
    args = add_repetitions_flag(
        make_parser(__doc__, rounds=100, nodes=0)).parse_args(argv)
    generator = set_seed(args.seed)
    stacked, dim = ormandi_data(args.nodes, args.seed)
    sim = ormandi_sim(stacked, dim, args.seed, device=args.device)
    if args.repetitions > 1:
        seeds = [args.seed + i for i in range(args.repetitions)]
        _, reports = sim.run_repetitions(args.rounds, seeds)
        return finish(reports, args, local=False)
    state = sim.init_nodes(generator)
    state, report = sim.start(state, n_rounds=args.rounds)
    return finish(report, args, local=False)


if __name__ == "__main__":
    main()
