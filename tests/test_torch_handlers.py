"""The port's SGD handler and metrics against the JAX package's.

``SGDHandler.update`` and ``call`` run 4 nodes under the JAX draw oracle's
shard orders (the permutations ``jax.vmap(handler.update)`` draws from the
same keys); params within 1e-5, ages exactly. The metrics run on shared scores
and masks, within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gossipy_tpu.core import CreateModelMode
from gossipy_tpu.handlers import SGDHandler, losses
from gossipy_tpu.handlers.base import PeerModel as JPeerModel
from gossipy_tpu.models import LogisticRegression
from gossipy_tpu.utils import classification_metrics
from gossipy_tpu_torch import convert
from gossipy_tpu_torch.handlers import ModelState as TModelState
from gossipy_tpu_torch.handlers import PeerModel as TPeerModel
from gossipy_tpu_torch.handlers import SGDHandler as TSGDHandler
from gossipy_tpu_torch.handlers import losses as tlosses
from gossipy_tpu_torch.models import LogisticRegression as TLogReg
from gossipy_tpu_torch.utils import \
    classification_metrics as tclassification_metrics
from torch_oracle import perms_from_keys

torch.set_num_threads(1)

D, S, N = 6, 10, 4


def shards():
    """Padded shards: node 0 full, node 1 six real rows, node 2 one real
    row (so some of its batches are all padding), node 3 none at all."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(N, S, D)).astype(np.float32)
    y = rng.integers(0, 2, (N, S))
    mask = np.zeros((N, S), np.float32)
    for i, real in enumerate([S, 6, 1, 0]):
        mask[i, :real] = 1.0
    return X, y, mask


@pytest.mark.parametrize("epochs,batch", [(1, 4), (2, 4), (1, 16)])
def test_update_matches_vmapped_jax_update(epochs, batch):
    X, y, mask = shards()
    jh = SGDHandler(model=LogisticRegression(D, 2), loss=losses.cross_entropy,
                    optimizer=optax.sgd(0.3), local_epochs=epochs,
                    batch_size=batch, n_classes=2, input_shape=(D,))
    th = TSGDHandler(TLogReg(D, 2), tlosses.cross_entropy, learning_rate=0.3,
                     local_epochs=epochs, batch_size=batch, n_classes=2,
                     input_shape=(D,))
    keys = jax.random.split(jax.random.PRNGKey(9), N)
    init = jax.vmap(jh.init)(jax.random.split(jax.random.PRNGKey(1), N))
    want = jax.vmap(jh.update)(init, (jnp.asarray(X), jnp.asarray(y),
                                      jnp.asarray(mask)), keys)

    flat = convert.params_from_jax(jax.tree.map(np.asarray, init.params),
                                   th.layout)
    state = TModelState(flat, torch.zeros(N, dtype=torch.int32))
    perms = torch.from_numpy(perms_from_keys(keys, epochs, S)).long()
    got = th.update(state, (torch.from_numpy(X), torch.from_numpy(y),
                            torch.from_numpy(mask)), perms)

    views = convert.params_to_numpy(got.params, th.layout)
    for leaf in ("kernel", "bias"):
        np.testing.assert_allclose(views[f"Dense_0/{leaf}"],
                                   np.asarray(want.params["Dense_0"][leaf]),
                                   rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.n_updates.numpy(),
                                  np.asarray(want.n_updates))
    # The all-padding node is a no-op: same params, no counted update.
    assert got.n_updates[3] == 0
    np.testing.assert_array_equal(got.params[3].numpy(), flat[3].numpy())
    assert (got.params[:, th.layout.width:] == 0).all()


def test_evaluate_matches_vmapped_jax_evaluate():
    X, y, mask = shards()
    mask[3, :2] = 1.0  # give every node an eval row
    jh = SGDHandler(model=LogisticRegression(D, 2), loss=losses.cross_entropy,
                    n_classes=2, input_shape=(D,))
    th = TSGDHandler(TLogReg(D, 2), tlosses.cross_entropy, n_classes=2,
                     input_shape=(D,))
    init = jax.vmap(jh.init)(jax.random.split(jax.random.PRNGKey(2), N))
    want = jax.vmap(jh.evaluate)(init, (jnp.asarray(X), jnp.asarray(y),
                                        jnp.asarray(mask)))
    flat = convert.params_from_jax(jax.tree.map(np.asarray, init.params),
                                   th.layout)
    got = th.evaluate(TModelState(flat, None), (
        torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(mask)))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("n_classes", [2, 5])
@pytest.mark.parametrize("mask_kind", ["none", "padded", "empty"])
@pytest.mark.parametrize("ties", [False, True])
def test_classification_metrics_match(n_classes, mask_kind, ties):
    rng = np.random.default_rng(n_classes)
    e = 40
    scores = rng.normal(size=(e, n_classes)).astype(np.float32)
    if ties:  # rounded scores: many equal values, midranks matter
        scores = np.round(scores, 0).astype(np.float32)
    y = rng.integers(0, n_classes, e)
    mask = {"none": None,
            "padded": (rng.uniform(size=e) < 0.7).astype(np.float32),
            "empty": np.zeros(e, np.float32)}[mask_kind]
    want = classification_metrics(jnp.asarray(scores), jnp.asarray(y),
                                  n_classes,
                                  None if mask is None else jnp.asarray(mask))
    got = tclassification_metrics(torch.from_numpy(scores),
                                  torch.from_numpy(y), n_classes,
                                  None if mask is None
                                  else torch.from_numpy(mask))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_metrics_batch_over_nodes():
    """A leading node axis gives the per-node values of separate calls."""
    rng = np.random.default_rng(0)
    scores = torch.from_numpy(rng.normal(size=(3, 20, 2)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 2, (3, 20)))
    mask = torch.from_numpy((rng.uniform(size=(3, 20)) < 0.8)
                            .astype(np.float32))
    batched = tclassification_metrics(scores, y, 2, mask)
    for i in range(3):
        one = tclassification_metrics(scores[i], y[i], 2, mask[i])
        for k in one:
            assert torch.allclose(batched[k][i], one[k], atol=1e-7)


@pytest.mark.parametrize("mode", [CreateModelMode.UPDATE,
                                  CreateModelMode.MERGE_UPDATE,
                                  CreateModelMode.PASS])
def test_call_matches_vmapped_jax_call(mode):
    """The receive-time dispatch over every node at once, under the
    oracle's shard orders: merge as ``(a + b) / 2.0`` with age = max."""
    X, y, mask = shards()
    kw = dict(local_epochs=1, batch_size=4, n_classes=2, input_shape=(D,),
              create_model_mode=mode)
    jh = SGDHandler(model=LogisticRegression(D, 2), loss=losses.cross_entropy,
                    optimizer=optax.sgd(0.3), **kw)
    th = TSGDHandler(TLogReg(D, 2), tlosses.cross_entropy, learning_rate=0.3,
                     **kw)
    own = jax.vmap(jh.init)(jax.random.split(jax.random.PRNGKey(1), N))
    own = own._replace(n_updates=jnp.array([0, 3, 5, 1], jnp.int32))
    peer = jax.vmap(jh.init)(jax.random.split(jax.random.PRNGKey(2), N))
    peer_ages = jnp.array([2, 2, 4, 0], jnp.int32)
    keys = jax.random.split(jax.random.PRNGKey(9), N)
    want = jax.vmap(jh.call)(own, JPeerModel(peer.params, peer_ages),
                             (jnp.asarray(X), jnp.asarray(y),
                              jnp.asarray(mask)), keys)

    def flat(tree):
        return convert.params_from_jax(jax.tree.map(np.asarray, tree),
                                       th.layout)
    perms = torch.from_numpy(perms_from_keys(keys, 1, S)).long()
    got = th.call(TModelState(flat(own.params),
                              torch.from_numpy(np.array(own.n_updates))),
                  TPeerModel(flat(peer.params),
                             torch.from_numpy(np.array(peer_ages))),
                  (torch.from_numpy(X), torch.from_numpy(y),
                   torch.from_numpy(mask)), perms)
    views = convert.params_to_numpy(got.params, th.layout)
    for leaf in ("kernel", "bias"):
        np.testing.assert_allclose(views[f"Dense_0/{leaf}"],
                                   np.asarray(want.params["Dense_0"][leaf]),
                                   rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.n_updates.numpy(),
                                  np.asarray(want.n_updates))


def test_merge_is_the_rounded_average():
    th = TSGDHandler(TLogReg(D, 2), tlosses.cross_entropy, input_shape=(D,))
    a = torch.tensor([[1.0, 3.0, 1e-45, 3.4e38]])
    b = torch.tensor([[2.0, -1.0, 1e-45, 3.4e38]])
    got = th.merge(TModelState(a, torch.tensor([4])),
                   TPeerModel(b, torch.tensor([7])))
    assert torch.equal(got.params, (a + b) / 2.0)
    assert got.n_updates.tolist() == [7]


def test_update_merge_is_not_ported():
    th = TSGDHandler(TLogReg(D, 2), tlosses.cross_entropy, input_shape=(D,),
                     create_model_mode=CreateModelMode.UPDATE_MERGE)
    st = TModelState(torch.zeros(1, 4), torch.zeros(1, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="UPDATE_MERGE"):
        th.call(st, TPeerModel(*st), None, None)
