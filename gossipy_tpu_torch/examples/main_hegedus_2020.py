"""Hegedus, Danner and Jelasity 2020: gossip matrix factorisation.

Twin of the JAX package's ``examples/main_hegedus_2020.py``, built
through the port's entry points: MovieLens ratings (the synthetic
stand-in of :func:`~gossipy_tpu_torch.data.load_recsys_dataset`: 943
users, 1,682 items, 106 ratings a user for ml-100k), split 90/10 per
user, one user a node, ``MFHandler(dim=5, lam_reg=0.1,
learning_rate=0.001)`` under MERGE_UPDATE (only the item factors and
biases travel), ``random_regular(n, 20, seed=42)``, sync PUSH with
``UniformDelay(0, 10)``, a 10% sampled evaluation, user-wise (local)
RMSE. The merge is age-weighted, not a uniform average: the plain
deliver path. ``--dataset ml-1m`` takes the larger set (6,040 users). It
runs on the card; ``--device cpu`` runs on the host:

    python3 -m gossipy_tpu_torch.examples.main_hegedus_2020
    python3 -m gossipy_tpu_torch.examples.main_hegedus_2020 \\
        --device cpu --rounds 10
"""

from __future__ import annotations

import warnings

from gossipy_tpu_torch import set_seed
from gossipy_tpu_torch.core import AntiEntropyProtocol, CreateModelMode, \
    Topology, UniformDelay
from gossipy_tpu_torch.data import RecSysDataDispatcher, RecSysDataHandler, \
    load_recsys_dataset
from gossipy_tpu_torch.examples._common import finish, make_parser
from gossipy_tpu_torch.handlers import MFHandler
from gossipy_tpu_torch.random import TorchDraws
from gossipy_tpu_torch.simulation import GossipSimulator

DEGREE = 20


def hegedus_data(dataset: str = "ml-100k", seed: int = 42,
                 users: int = 0, sets=None) -> tuple:
    """``(stacked, n_items)``: the ratings of ``dataset`` (or ``sets =
    (ratings, n_users, n_items)``), each user's split 90/10 with
    ``seed``, one user a node in a seeded order; the first ``users``
    users only when it is set (the items stay all of them)."""
    if sets is None:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # the synthetic stand-in's note
            sets = load_recsys_dataset(dataset)
    ratings, n_users, n_items = sets
    dh = RecSysDataHandler(ratings, users or n_users, n_items,
                           test_size=0.1, seed=seed)
    return RecSysDataDispatcher(dh).stacked(), n_items


def hegedus_sim(stacked, n_items: int, seed: int = 42, draws=None,
                device=None, **kw) -> GossipSimulator:
    """The Hegedus simulator over ``stacked``: MF (dim 5, lambda 0.1, lr
    0.001), MERGE_UPDATE, ``random_regular(n, min(20, n - 1),
    seed=42)``, sync PUSH, ``UniformDelay(0, 10)``,
    ``sampling_eval=0.1``; draws from ``TorchDraws(seed)`` unless
    ``draws`` is given."""
    n = int(stacked["mtr"].shape[0])
    handler = MFHandler(dim=5, n_items=n_items, lam_reg=0.1,
                        learning_rate=0.001,
                        create_model_mode=CreateModelMode.MERGE_UPDATE)
    return GossipSimulator(
        handler, Topology.random_regular(n, min(DEGREE, n - 1), seed=42),
        stacked, delta=100, protocol=AntiEntropyProtocol.PUSH,
        delay=UniformDelay(0, 10), sampling_eval=0.1, sync=True,
        draws=draws if draws is not None else TorchDraws(seed),
        device=device, **kw)


def main(argv=None) -> dict:
    parser = make_parser(__doc__, rounds=100)
    parser.add_argument("--dataset", choices=["ml-100k", "ml-1m"],
                        default="ml-100k")
    args = parser.parse_args(argv)
    generator = set_seed(args.seed)
    stacked, n_items = hegedus_data(args.dataset, args.seed)
    sim = hegedus_sim(stacked, n_items, args.seed, device=args.device)
    state = sim.init_nodes(generator)
    state, report = sim.start(state, n_rounds=args.rounds)
    return finish(report, args, local=True)   # user-wise RMSE


if __name__ == "__main__":
    main()
