"""Onoszko et al. 2021: PENS peer selection on CIFAR-10.

Twin of the JAX package's ``examples/main_onoszko_2021.py``, built
through the port's entry points: the CIFAR-10 stand-in (the port loads no
archive and tries no download) normalised by its own mean and standard
deviation, the second half of the training and of the test images
flipped vertically (two clusters), ``CIFAR10Net`` under
``chain(add_decayed_weights(1e-3), sgd(0.01))``, batch 8, 3 local epochs,
MERGE_UPDATE; 5 PENS nodes on a clique, each holding a contiguous block
of the training images; async PUSH, ``n_sampled = min(10, n - 1)``
(the original's 10 can never fill a sender-keyed buffer of 4 peers),
``m_top = 2``, ``step1_rounds = 100``, a 10% sampled evaluation, 500
rounds. PENS's receive is its own: the plain deliver path. It runs on
the card; ``--device cpu`` runs on the host:

    python3 -m gossipy_tpu_torch.examples.main_onoszko_2021
    python3 -m gossipy_tpu_torch.examples.main_onoszko_2021 \\
        --device cpu --nodes 3 --subsample 48 --step1-rounds 2 --rounds 4
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from gossipy_tpu_torch import set_seed
from gossipy_tpu_torch.core import AntiEntropyProtocol, CreateModelMode, \
    Topology
from gossipy_tpu_torch.data import ClassificationDataHandler, \
    DataDispatcher, get_CIFAR10
from gossipy_tpu_torch.examples._common import finish, make_parser
from gossipy_tpu_torch.handlers import SGDHandler, losses
from gossipy_tpu_torch.models import CIFAR10Net
from gossipy_tpu_torch.optim import add_decayed_weights, chain, sgd
from gossipy_tpu_torch.random import TorchDraws
from gossipy_tpu_torch.simulation import PENSGossipSimulator


def contiguous_assignment(n_samples: int, n_nodes: int) -> list:
    """Contiguous blocks of ``ceil(n_samples / n_nodes)`` indices, one a
    node (the original's custom dispatcher)."""
    per = -(-n_samples // n_nodes)
    return [np.arange(i * per, min((i + 1) * per, n_samples))
            for i in range(n_nodes)]


def onoszko_data(nodes: int = 5, subsample: int = 0, sets=None) -> dict:
    """The stacked data: the CIFAR-10 stand-in (or ``sets = ((Xtr, ytr),
    (Xte, yte))``), cut to ``subsample`` training and ``subsample // 5``
    test images when it is set, normalised, its second halves flipped
    vertically, the training images in contiguous blocks over ``nodes``
    nodes; the test images are the global eval set."""
    if sets is None:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # the stand-in's note
            sets = get_CIFAR10()
    (Xtr, ytr), (Xte, yte) = sets
    if subsample:
        Xtr, ytr = Xtr[:subsample], ytr[:subsample]
        Xte, yte = Xte[:subsample // 5 or 1], yte[:subsample // 5 or 1]
    Xtr = (Xtr - Xtr.mean()) / (Xtr.std() + 1e-8)
    Xte = (Xte - Xte.mean()) / (Xte.std() + 1e-8)
    half, half_te = len(Xtr) // 2, len(Xte) // 2
    Xtr[half:] = Xtr[half:, ::-1, :, :]
    Xte[half_te:] = Xte[half_te:, ::-1, :, :]
    dh = ClassificationDataHandler(Xtr, ytr, Xte, yte)
    disp = DataDispatcher(dh, n=nodes, eval_on_user=False,
                          auto_assign=False)
    disp.set_assignments(contiguous_assignment(len(Xtr), nodes))
    return disp.stacked()


def onoszko_handler(compute_dtype=None) -> SGDHandler:
    """CIFAR10Net under weight decay 1e-3 and SGD 0.01, batch 8, 3 local
    epochs, MERGE_UPDATE."""
    return SGDHandler(
        CIFAR10Net(), losses.cross_entropy,
        optimizer=chain(add_decayed_weights(1e-3), sgd(0.01)),
        local_epochs=3, batch_size=8, n_classes=10,
        input_shape=(32, 32, 3), compute_dtype=compute_dtype,
        create_model_mode=CreateModelMode.MERGE_UPDATE)


def onoszko_sim(stacked, step1_rounds: int = 100, seed: int = 42,
                draws=None, device=None, bf16: bool = False,
                **kw) -> PENSGossipSimulator:
    """The PENS simulator over ``stacked``: a clique, async PUSH,
    ``n_sampled = min(10, n - 1)``, ``m_top = 2``, ``sampling_eval=0.1``;
    ``bf16`` computes the forward and backward passes in bfloat16 (not
    in the original); draws from ``TorchDraws(seed)`` unless ``draws`` is
    given; ``kw`` goes to the simulator."""
    n = int(stacked["mtr"].shape[0])
    return PENSGossipSimulator(
        onoszko_handler(torch.bfloat16 if bf16 else None),
        Topology.clique(n), stacked,
        n_sampled=min(10, n - 1), m_top=2, step1_rounds=step1_rounds,
        delta=100, protocol=AntiEntropyProtocol.PUSH, sampling_eval=0.1,
        sync=False, draws=draws if draws is not None else TorchDraws(seed),
        device=device, **kw)


def main(argv=None) -> dict:
    parser = make_parser(__doc__, rounds=500, nodes=5)
    parser.add_argument("--subsample", type=int, default=0,
                        help="cap train/test sizes (0 = full)")
    parser.add_argument("--step1-rounds", type=int, default=100)
    args = parser.parse_args(argv)
    generator = set_seed(args.seed)
    stacked = onoszko_data(args.nodes, args.subsample)
    sim = onoszko_sim(stacked, args.step1_rounds, args.seed,
                      device=args.device)
    state = sim.init_nodes(generator)
    state, report = sim.start(state, n_rounds=args.rounds)
    return finish(report, args, local=False)


if __name__ == "__main__":
    main()
