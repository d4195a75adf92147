"""Giaretta and Girdzijauskas 2019: gossip learning on a power-law graph.

Twin of the JAX package's ``examples/main_giaretta_2019.py``, built
through the port's entry points: the spambase stand-in with ±1 labels
split 90/10, one node per training sample (4,141), ``PegasosHandler``
over ``AdaLine`` (lambda 0.01) under MERGE_UPDATE on
``barabasi_albert(n, 10)``, async PUSH, a 10% sampled evaluation.
``--variant`` picks the node behaviour: ``vanilla`` (the plain
simulator; Pegasos's merge is the uniform average, so the port's default
deliver is the single-pass fused one, one launch of the multi-slot
gather-merge kernel a round with messages), ``passthrough``
(``PassThroughGossipSimulator``) or ``cacheneigh``
(``CacheNeighGossipSimulator``), both on the plain path. It runs on the
card; ``--device cpu`` runs the plain versions on the host:

    python3 -m gossipy_tpu_torch.examples.main_giaretta_2019
    python3 -m gossipy_tpu_torch.examples.main_giaretta_2019 \\
        --variant cacheneigh --device cpu --nodes 64 --rounds 10
"""

from __future__ import annotations

import warnings

import numpy as np

from gossipy_tpu_torch import set_seed
from gossipy_tpu_torch.core import AntiEntropyProtocol, CreateModelMode, \
    Topology
from gossipy_tpu_torch.data import ClassificationDataHandler, \
    DataDispatcher, load_classification_dataset
from gossipy_tpu_torch.examples._common import finish, make_parser
from gossipy_tpu_torch.handlers import PegasosHandler
from gossipy_tpu_torch.models import AdaLine
from gossipy_tpu_torch.random import TorchDraws
from gossipy_tpu_torch.simulation import CacheNeighGossipSimulator, \
    GossipSimulator, PassThroughGossipSimulator

SIMULATORS = {"vanilla": GossipSimulator,
              "passthrough": PassThroughGossipSimulator,
              "cacheneigh": CacheNeighGossipSimulator}
ATTACH = 10   # the Barabasi-Albert graph's m


def giaretta_data(nodes: int = 0, seed: int = 42, sets=None) -> tuple:
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


def giaretta_sim(stacked, dim: int, variant: str = "vanilla",
                 seed: int = 42, draws=None, device=None,
                 **kw) -> GossipSimulator:
    """Variant ``variant``'s simulator over ``stacked``: Pegasos (lambda
    0.01), MERGE_UPDATE, ``barabasi_albert(n, min(10, n - 1), seed)``,
    async PUSH, ``sampling_eval=0.1``; draws from ``TorchDraws(seed)``
    unless ``draws`` is given; ``kw`` goes to the simulator."""
    n = int(stacked["mtr"].shape[0])
    handler = PegasosHandler(net=AdaLine(dim), learning_rate=0.01,
                             create_model_mode=CreateModelMode.MERGE_UPDATE)
    return SIMULATORS[variant](
        handler, Topology.barabasi_albert(n, min(ATTACH, n - 1), seed=seed),
        stacked, delta=100, protocol=AntiEntropyProtocol.PUSH,
        sampling_eval=0.1, sync=False,
        draws=draws if draws is not None else TorchDraws(seed),
        device=device, **kw)


def main(argv=None) -> dict:
    parser = make_parser(__doc__, rounds=100, nodes=0)
    parser.add_argument("--variant", choices=sorted(SIMULATORS),
                        default="vanilla", help="node behaviour")
    args = parser.parse_args(argv)
    generator = set_seed(args.seed)
    stacked, dim = giaretta_data(args.nodes, args.seed)
    sim = giaretta_sim(stacked, dim, args.variant, args.seed,
                       device=args.device)
    state = sim.init_nodes(generator)
    state, report = sim.start(state, n_rounds=args.rounds)
    return finish(report, args, local=False)


if __name__ == "__main__":
    main()
