"""All-to-all gossip with mixing weights (Koloskova et al. 2020 style).

Twin of the JAX package's ``examples/main_all2all.py``, built through the
port's entry points: the spambase stand-in split 90/10, 100 nodes on
``random_regular(100, 20, seed=42)``, ``WeightedSGDHandler`` over
``LogisticRegression(57, 2)`` under ``chain(add_decayed_weights(1e-2),
sgd(0.1))``, batch 32, MERGE_UPDATE; every node that fires pushes to all
its peers and the receivers mix with ``--mixing`` weights (uniform or
Metropolis-Hastings): the whole population's merge is one ``W_eff @ P``
matrix product a round. Async, a 10% sampled evaluation, 100 rounds.
``--probes``, ``--sentinels`` and ``--chaos`` (a half/half partition over
the middle third of the run) switch on the gossip-dynamics probes, the
numerics sentinels and the scheduled faults, and the summary reports
them. It runs on the card; ``--device cpu`` runs on the host:

    python3 -m gossipy_tpu_torch.examples.main_all2all
    python3 -m gossipy_tpu_torch.examples.main_all2all \\
        --mixing metropolis --device cpu --nodes 16 --rounds 10
"""

from __future__ import annotations

import warnings

from gossipy_tpu_torch import set_seed
from gossipy_tpu_torch.core import AntiEntropyProtocol, CreateModelMode, \
    Topology, metropolis_hastings_mixing, uniform_mixing
from gossipy_tpu_torch.data import ClassificationDataHandler, \
    DataDispatcher, load_classification_dataset
from gossipy_tpu_torch.examples._common import add_chaos_flag, \
    add_probes_flag, add_sentinels_flag, demo_chaos_config, finish, \
    make_parser
from gossipy_tpu_torch.handlers import WeightedSGDHandler, losses
from gossipy_tpu_torch.models import LogisticRegression
from gossipy_tpu_torch.optim import add_decayed_weights, chain, sgd
from gossipy_tpu_torch.random import TorchDraws
from gossipy_tpu_torch.simulation import All2AllGossipSimulator

DEGREE = 20
MIXINGS = {"uniform": uniform_mixing,
           "metropolis": metropolis_hastings_mixing}


def all2all_data(nodes: int = 100, seed: int = 42, sets=None) -> tuple:
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


def all2all_sim(stacked, dim: int, mixing: str = "uniform", seed: int = 42,
                draws=None, device=None, **kw) -> All2AllGossipSimulator:
    """The all-to-all simulator over ``stacked`` with ``mixing`` weights
    on ``random_regular(n, min(20, n - 1), seed=42)``; draws from
    ``TorchDraws(seed)`` unless ``draws`` is given; ``kw`` goes to the
    simulator."""
    n = int(stacked["mtr"].shape[0])
    topology = Topology.random_regular(n, min(DEGREE, n - 1), seed=42,
                                        backend="networkx")
    handler = WeightedSGDHandler(
        LogisticRegression(dim, 2), losses.cross_entropy,
        optimizer=chain(add_decayed_weights(1e-2), sgd(0.1)),
        local_epochs=1, batch_size=32, n_classes=2, input_shape=(dim,),
        create_model_mode=CreateModelMode.MERGE_UPDATE)
    return All2AllGossipSimulator(
        handler, topology, stacked, mixing=MIXINGS[mixing](topology),
        delta=100, protocol=AntiEntropyProtocol.PUSH, sampling_eval=0.1,
        sync=False, draws=draws if draws is not None else TorchDraws(seed),
        device=device, **kw)


def main(argv=None) -> dict:
    parser = make_parser(__doc__, rounds=100, nodes=100)
    parser.add_argument("--mixing", choices=sorted(MIXINGS),
                        default="uniform")
    add_probes_flag(parser)
    add_sentinels_flag(parser)
    add_chaos_flag(parser)
    args = parser.parse_args(argv)
    generator = set_seed(args.seed)
    stacked, dim = all2all_data(args.nodes, args.seed)
    sim = all2all_sim(stacked, dim, args.mixing, args.seed,
                      device=args.device, probes=args.probes,
                      sentinels=args.sentinels,
                      chaos=demo_chaos_config(args))
    state = sim.init_nodes(generator)
    state, report = sim.start(state, n_rounds=args.rounds)
    return finish(report, args, local=False)


if __name__ == "__main__":
    main()
