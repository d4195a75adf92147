"""Hegedus, Danner and Jelasity 2021: partitioned and sampled exchange.

Twin of the JAX package's ``examples/main_hegedus_2021.py``, built
through the port's entry points: the spambase stand-in split 90/10, 100
nodes on ``random_regular(100, 20, seed=42)``, ``LogisticRegression(57,
2)`` under ``chain(add_decayed_weights(1e-3), sgd(1.0))``, batch 32,
cross-entropy, UPDATE mode, sync PUSH with ``UniformDelay(0, 10)``, a 10%
sampled evaluation, 1000 rounds. ``--variant partitioning`` (the
default): the model cut into 4 parts with an age each
(``PartitionedSGDHandler``), under token-account flow control with
``RandomizedTokenAccount(C=20, A=10)`` and a constant utility
(``TokenizedPartitioningGossipSimulator``); ``--variant sampling``: a
random quarter of the coordinates merged (``SamplingSGDHandler(0.25)``,
``SamplingGossipSimulator``). Neither merge is a uniform average: the
plain deliver path. It runs on the card; ``--device cpu`` runs on the
host:

    python3 -m gossipy_tpu_torch.examples.main_hegedus_2021
    python3 -m gossipy_tpu_torch.examples.main_hegedus_2021 \\
        --variant sampling --device cpu --nodes 16 --rounds 10
"""

from __future__ import annotations

import warnings

from gossipy_tpu_torch import set_seed
from gossipy_tpu_torch.compression import ModelPartition
from gossipy_tpu_torch.core import AntiEntropyProtocol, CreateModelMode, \
    Topology, UniformDelay
from gossipy_tpu_torch.data import ClassificationDataHandler, \
    DataDispatcher, load_classification_dataset
from gossipy_tpu_torch.examples._common import finish, make_parser
from gossipy_tpu_torch.flow_control import RandomizedTokenAccount
from gossipy_tpu_torch.handlers import PartitionedSGDHandler, \
    SamplingSGDHandler, losses
from gossipy_tpu_torch.models import LogisticRegression
from gossipy_tpu_torch.models.nn import ParamLayout
from gossipy_tpu_torch.optim import add_decayed_weights, chain, sgd
from gossipy_tpu_torch.random import TorchDraws
from gossipy_tpu_torch.simulation import SamplingGossipSimulator, \
    TokenizedPartitioningGossipSimulator

DEGREE = 20
PARTS = 4
SAMPLE = 0.25


def hegedus2021_data(nodes: int = 100, seed: int = 42, sets=None) -> tuple:
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


def hegedus2021_sim(stacked, dim: int, variant: str = "partitioning",
                    seed: int = 42, draws=None, device=None,
                    token_account=None, **kw):
    """Variant ``variant``'s simulator over ``stacked``: the handler and
    network above; the partitioned one under ``token_account`` (default
    ``RandomizedTokenAccount(C=20, A=10)``); draws from
    ``TorchDraws(seed)`` unless ``draws`` is given; ``kw`` goes to the
    simulator."""
    n = int(stacked["mtr"].shape[0])
    model = LogisticRegression(dim, 2)
    common = dict(loss=losses.cross_entropy,
                  optimizer=chain(add_decayed_weights(1e-3), sgd(1.0)),
                  local_epochs=1, batch_size=32, n_classes=2,
                  input_shape=(dim,),
                  create_model_mode=CreateModelMode.UPDATE)
    net = dict(delta=100, protocol=AntiEntropyProtocol.PUSH,
               delay=UniformDelay(0, 10), sampling_eval=0.1, sync=True,
               draws=draws if draws is not None else TorchDraws(seed),
               device=device, **kw)
    topology = Topology.random_regular(n, min(DEGREE, n - 1), seed=42,
                                        backend="networkx")
    if variant == "partitioning":
        handler = PartitionedSGDHandler(
            ModelPartition(ParamLayout(model.leaves), PARTS), model,
            **common)
        return TokenizedPartitioningGossipSimulator(
            handler, topology, stacked,
            token_account=token_account or RandomizedTokenAccount(C=20,
                                                                  A=10),
            **net)
    if variant != "sampling":
        raise ValueError(f"unknown variant {variant!r}")
    return SamplingGossipSimulator(SamplingSGDHandler(SAMPLE, model,
                                                      **common),
                                   topology, stacked, **net)


def main(argv=None) -> dict:
    parser = make_parser(__doc__, rounds=1000, nodes=100)
    parser.add_argument("--variant", choices=["partitioning", "sampling"],
                        default="partitioning")
    args = parser.parse_args(argv)
    generator = set_seed(args.seed)
    stacked, dim = hegedus2021_data(args.nodes, args.seed)
    sim = hegedus2021_sim(stacked, dim, args.variant, args.seed,
                          device=args.device)
    state = sim.init_nodes(generator)
    state, report = sim.start(state, n_rounds=args.rounds)
    return finish(report, args, local=False)


if __name__ == "__main__":
    main()
