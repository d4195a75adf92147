"""Berta, Bilicki and Jelasity 2014: gossip k-means clustering.

Twin of the JAX package's ``examples/main_berta_2014.py``, built through
the port's entry points: the spambase stand-in as a clustering problem
(the eval set is the training set), one node per sample (4,601) on a
clique, ``KMeansHandler(k=2, alpha=0.1, matching="hungarian")`` under
MERGE_UPDATE, sync PUSH with 10% drops, a 1% sampled evaluation, 500
rounds of length 1000. The engine's merges are of stacked rows, so they
match centroids greedily, as the JAX engine's traced merges do. The
merge is not a uniform average: the plain deliver path.

Before the gossip run it prints the NMI of the plain numpy Lloyd
baseline (scored by the port's ``nmi``). The JAX script's second
baseline, scikit-learn's ``KMeans``, is left out: the port does not
depend on scikit-learn. It runs on the card; ``--device cpu`` runs on
the host:

    python3 -m gossipy_tpu_torch.examples.main_berta_2014
    python3 -m gossipy_tpu_torch.examples.main_berta_2014 \\
        --device cpu --nodes 64 --rounds 10
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from gossipy_tpu_torch import set_seed
from gossipy_tpu_torch.core import AntiEntropyProtocol, CreateModelMode, \
    Topology
from gossipy_tpu_torch.data import ClusteringDataHandler, DataDispatcher, \
    load_classification_dataset
from gossipy_tpu_torch.examples._common import finish, make_parser
from gossipy_tpu_torch.handlers import KMeansHandler
from gossipy_tpu_torch.random import TorchDraws
from gossipy_tpu_torch.simulation import GossipSimulator
from gossipy_tpu_torch.utils import nmi


def numpy_kmeans(X: np.ndarray, k: int = 2, max_iterations: int = 400,
                 seed: int = 42) -> np.ndarray:
    """Plain Lloyd's algorithm baseline: each sample's cluster."""
    rng = np.random.default_rng(seed)
    centroids = X[rng.choice(len(X), k, replace=False)]
    assign = np.argmin(((X[:, None] - centroids[None]) ** 2).sum(-1), axis=1)
    for _ in range(max_iterations):
        centroids = np.stack([
            X[assign == i].mean(axis=0) if (assign == i).any() else centroids[i]
            for i in range(k)])
        new = np.argmin(((X[:, None] - centroids[None]) ** 2).sum(-1), axis=1)
        if np.array_equal(assign, new):
            break
        assign = new
    return assign


def load_spambase() -> tuple:
    """The normalised spambase stand-in, ``(X, y)``."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the offline stand-in's note
        return load_classification_dataset("spambase", normalize=True)


def berta_data(nodes: int = 0, sets=None) -> tuple:
    """``(stacked, dim)``: the clustering data of ``sets = (X, y)`` (the
    spambase stand-in by default), one node per sample unless ``nodes``
    is set; every sample is also in the global eval set."""
    X, y = sets if sets is not None else load_spambase()
    dh = ClusteringDataHandler(X, y)
    n = nodes or dh.size()
    return DataDispatcher(dh, n=n, eval_on_user=False).stacked(), dh.size(1)


def berta_sim(stacked, dim: int, seed: int = 42, draws=None,
              device=None, **kw) -> GossipSimulator:
    """The Berta simulator over ``stacked``: k-means (k 2, alpha 0.1,
    Hungarian matching), MERGE_UPDATE, clique, sync PUSH, ``delta=1000``,
    drop 0.1, ``sampling_eval=0.01``; draws from ``TorchDraws(seed)``
    unless ``draws`` is given; ``kw`` goes to the simulator."""
    n = int(stacked["mtr"].shape[0])
    handler = KMeansHandler(k=2, dim=dim, alpha=0.1, matching="hungarian",
                            create_model_mode=CreateModelMode.MERGE_UPDATE)
    return GossipSimulator(
        handler, Topology.clique(n), stacked, delta=1000,
        protocol=AntiEntropyProtocol.PUSH, drop_prob=0.1,
        sampling_eval=0.01, sync=True,
        draws=draws if draws is not None else TorchDraws(seed),
        device=device, **kw)


def main(argv=None) -> dict:
    args = make_parser(__doc__, rounds=500, nodes=0).parse_args(argv)
    generator = set_seed(args.seed)
    X, y = load_spambase()
    base = numpy_kmeans(X, k=2, seed=args.seed)
    score = nmi(torch.as_tensor(y), torch.as_tensor(base), 2, 2)
    print("K-means NMI:", float(score), flush=True)
    stacked, dim = berta_data(args.nodes, (X, y))
    sim = berta_sim(stacked, dim, args.seed, device=args.device)
    state = sim.init_nodes(generator, local_train=True)
    state, report = sim.start(state, n_rounds=args.rounds)
    return finish(report, args, local=False)


if __name__ == "__main__":
    main()
