"""Centralized baselines: what a single global model reaches.

Twin of ``examples/baseline.py``: the quality anchor gossip runs are
compared against, a centralized MLP (``MLP(d, 2, hidden_dims=(100,))``)
trained on the full, undistributed training set through the same handler
machinery the gossip nodes use (``SGDHandler`` with ``optim.chain(
add_decayed_weights(l2), sgd(lr))``, batch 16, one row), and
scikit-learn's ``MLPClassifier`` beside it. It prints the JAX script's
JSON line: ``flax_mlp`` names the handler-machinery MLP (here the
port's), ``sklearn_mlp`` scikit-learn's. The scikit-learn half runs only
where scikit-learn imports; elsewhere (the card's machine has none) its
key holds null and ``sklearn_mlp_skipped`` the reason. The port's half
always runs.

    python3 -m gossipy_tpu_torch.examples.baseline --rounds 300
    python3 -m gossipy_tpu_torch.examples.baseline --device cpu --rounds 5
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from gossipy_tpu_torch import resolve_device, set_seed
from gossipy_tpu_torch.data import ClassificationDataHandler, \
    load_classification_dataset
from gossipy_tpu_torch.examples._common import make_parser
from gossipy_tpu_torch.handlers import SGDHandler, losses
from gossipy_tpu_torch.handlers.base import ModelState
from gossipy_tpu_torch.models import MLP
from gossipy_tpu_torch.optim import add_decayed_weights, chain, sgd


def mlp_handler(d: int, n_epochs: int, batch_size: int = 16,
                learning_rate: float = 0.01,
                l2_reg: float = 0.001) -> SGDHandler:
    return SGDHandler(
        model=MLP(d, 2, hidden_dims=(100,)), loss=losses.cross_entropy,
        optimizer=chain(add_decayed_weights(l2_reg), sgd(learning_rate)),
        local_epochs=n_epochs, batch_size=batch_size, n_classes=2,
        input_shape=(d,))


def torch_mlp(data_handler, n_epochs: int = 300, batch_size: int = 16,
              learning_rate: float = 0.01, l2_reg: float = 0.001,
              seed: int = 42, device=None,
              state: Optional[ModelState] = None,
              perms: Optional[torch.Tensor] = None) -> dict:
    """The centralized MLP, one row through ``SGDHandler.update``: the
    training set as one shard, ``n_epochs`` epochs over it in the orders
    ``perms`` (``[1, n_epochs, S]``; default one ``randperm`` an epoch
    from ``seed``), from ``state`` (a one-row ``ModelState``; default
    ``handler.init`` under ``seed``). Returns the eval set's metrics and
    the trained state under ``"_state"``."""
    dev = resolve_device(device)
    d = data_handler.size(1)
    handler = mlp_handler(d, n_epochs, batch_size, learning_rate, l2_reg)
    g = torch.Generator().manual_seed(seed)
    if state is None:
        one = handler.init(g, dev)
        state = ModelState(one.params[None],
                           tuple(t[None] for t in one.opt_state),
                           one.n_updates[None])
    Xtr, ytr = data_handler.get_train_set()
    s = len(Xtr)
    if perms is None:
        perms = torch.stack([torch.randperm(s, generator=g)
                             for _ in range(n_epochs)])[None]
    data = (torch.as_tensor(np.asarray(Xtr), dtype=torch.float32,
                            device=dev)[None],
            torch.as_tensor(np.asarray(ytr), device=dev)[None],
            torch.ones((1, s), device=dev))
    state = handler.update(
        ModelState(state.params.to(dev),
                   tuple(t.to(dev) for t in state.opt_state),
                   state.n_updates.to(dev)), data, perms.to(dev))
    Xte, yte = data_handler.get_eval_set()
    res = handler.evaluate(state, (
        torch.as_tensor(np.asarray(Xte), dtype=torch.float32,
                        device=dev)[None],
        torch.as_tensor(np.asarray(yte), device=dev)[None],
        torch.ones((1, len(Xte)), device=dev)))
    out = {k: float(v[0]) for k, v in res.items()}
    out["_state"] = state
    return out


def sklearn_mlp(data_handler, n_epochs: int = 300, batch_size: int = 16,
                learning_rate: float = 0.01, l2_reg: float = 0.001) -> dict:
    """scikit-learn's ``MLPClassifier`` on the same split (imported at the
    call: ImportError without scikit-learn)."""
    from sklearn import metrics, neural_network as nn
    Xtr, ytr = data_handler.get_train_set()
    Xte, yte = data_handler.get_eval_set()
    clf = nn.MLPClassifier(max_iter=n_epochs,
                           learning_rate_init=learning_rate, alpha=l2_reg,
                           batch_size=batch_size, verbose=False).fit(
        Xtr, np.asarray(ytr).ravel())
    return {
        "accuracy": float(metrics.accuracy_score(yte, clf.predict(Xte))),
        "auc": float(metrics.roc_auc_score(yte,
                                           clf.predict_proba(Xte)[:, 1])),
    }


def main(argv=None) -> dict:
    parser = make_parser(__doc__, rounds=300, with_plot=False)
    parser.add_argument("--dataset", default="spambase")
    args = parser.parse_args(argv)
    set_seed(args.seed)

    X, y = load_classification_dataset(args.dataset)
    dh = ClassificationDataHandler(X, y, test_size=0.1, seed=args.seed)
    port = torch_mlp(dh, n_epochs=args.rounds, seed=args.seed,
                     device=args.device)
    port.pop("_state")
    out = {"flax_mlp": port}
    try:
        out["sklearn_mlp"] = sklearn_mlp(dh, n_epochs=args.rounds)
    except ImportError as e:
        out["sklearn_mlp"] = None
        out["sklearn_mlp_skipped"] = (f"scikit-learn is not installed "
                                      f"({e})")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
