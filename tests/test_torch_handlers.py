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
from gossipy_tpu.models import CIFAR10Net, LogisticRegression
from gossipy_tpu.utils import classification_metrics
from gossipy_tpu_torch import convert
from gossipy_tpu_torch.handlers import ModelState as TModelState
from gossipy_tpu_torch.handlers import PeerModel as TPeerModel
from gossipy_tpu_torch.handlers import SGDHandler as TSGDHandler
from gossipy_tpu_torch.handlers import losses as tlosses
from gossipy_tpu_torch import optim
from gossipy_tpu_torch.models import CIFAR10Net as TCIFAR10Net
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
    state = TModelState(flat, (), torch.zeros(N, dtype=torch.int32))
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
    got = th.evaluate(TModelState(flat, (), None), (
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
                                  CreateModelMode.PASS,
                                  CreateModelMode.UPDATE_MERGE])
def test_call_matches_vmapped_jax_call(mode):
    """The receive-time dispatch over every node at once, under the
    oracle's shard orders: merge as ``(a + b) / 2.0`` with age = max.
    UPDATE_MERGE trains under the orders of both halves of the split
    key."""
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
    split = mode == CreateModelMode.UPDATE_MERGE
    perms = torch.from_numpy(perms_from_keys(keys, 1, S, split)).long()
    got = th.call(TModelState(flat(own.params), (),
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
    got = th.merge(TModelState(a, (), torch.tensor([4])),
                   TPeerModel(b, torch.tensor([7])))
    assert torch.equal(got.params, (a + b) / 2.0)
    assert got.n_updates.tolist() == [7]


# (optax rule, port rule): each with the state it keeps.
RULES = {
    "sgd": (lambda: optax.sgd(0.3), lambda: optim.sgd(0.3)),
    "momentum": (lambda: optax.sgd(0.3, momentum=0.9),
                 lambda: optim.sgd(0.3, momentum=0.9)),
    "decay-sgd": (lambda: optax.chain(optax.add_decayed_weights(0.01),
                                      optax.sgd(0.3)),
                  lambda: optim.chain(optim.add_decayed_weights(0.01),
                                      optim.sgd(0.3))),
    "adam": (lambda: optax.adam(0.05), lambda: optim.adam(0.05)),
}


def port_data(X, y, mask):
    return (torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(mask))


def jax_state(jh, seed):
    """N nodes' JAX states with random optimizer state where it has one
    (so a test sees which node's state a step reads)."""
    st = jax.vmap(jh.init)(jax.random.split(jax.random.PRNGKey(seed), N))
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.asarray(a)
        if a.dtype == np.int32:   # adam's count
            return jnp.asarray(rng.integers(0, 5, a.shape), jnp.int32)
        return jnp.asarray(0.1 * rng.normal(size=a.shape), jnp.float32)
    return st._replace(opt_state=jax.tree.map(fill, st.opt_state))


def port_state(th, jst):
    return TModelState(
        convert.params_from_jax(jax.tree.map(np.asarray, jst.params),
                                th.layout),
        convert.opt_state_from_jax(jax.tree.map(np.asarray, jst.opt_state),
                                   th.layout, th.optimizer),
        torch.from_numpy(np.array(jst.n_updates)))


def assert_state_close(th, got, want, atol=1e-5):
    """Params, every optimizer-state tensor and the ages."""
    views = convert.params_to_numpy(got.params, th.layout)
    for name, v in convert.flatten_names(want.params).items():
        np.testing.assert_allclose(views[name], np.asarray(v), rtol=0,
                                   atol=atol, err_msg=name)
    conv = convert.opt_state_from_jax(
        jax.tree.map(np.asarray, want.opt_state), th.layout, th.optimizer)
    assert len(got.opt_state) == len(conv)
    for a, b in zip(got.opt_state, conv):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=atol)
    np.testing.assert_array_equal(got.n_updates.numpy(),
                                  np.asarray(want.n_updates))


@pytest.mark.parametrize("rule", list(RULES))
def test_update_with_each_rule_matches_jax(rule):
    """Two epochs of batch 4 under each optimizer, from random optimizer
    state: params and state within 1e-5. Node 3's shard is all padding,
    node 2's batches mostly: an empty batch leaves params, state and
    count (adam's) as they were."""
    X, y, mask = shards()
    jrule, trule = (f() for f in RULES[rule])
    kw = dict(local_epochs=2, batch_size=4, n_classes=2, input_shape=(D,))
    jh = SGDHandler(model=LogisticRegression(D, 2), loss=losses.cross_entropy,
                    optimizer=jrule, **kw)
    th = TSGDHandler(TLogReg(D, 2), tlosses.cross_entropy, optimizer=trule,
                     **kw)
    jst = jax_state(jh, 1)
    keys = jax.random.split(jax.random.PRNGKey(9), N)
    want = jax.vmap(jh.update)(jst, (jnp.asarray(X), jnp.asarray(y),
                                     jnp.asarray(mask)), keys)
    before = port_state(th, jst)
    perms = torch.from_numpy(perms_from_keys(keys, 2, S)).long()
    got = th.update(before, port_data(X, y, mask), perms)
    assert_state_close(th, got, want)
    assert torch.equal(got.params[3], before.params[3])
    for a, b in zip(got.opt_state, before.opt_state):
        assert torch.equal(a[3], b[3])
    assert (got.params[:, th.layout.width:] == 0).all()


def test_merge_keeps_the_receivers_opt_state():
    th = TSGDHandler(TLogReg(D, 2), tlosses.cross_entropy,
                     optimizer=optim.adam(0.1), input_shape=(D,))
    own = th.init(device="cpu")
    stack = TModelState(own.params[None], tuple(t[None] + 3
                                                for t in own.opt_state),
                        own.n_updates[None])
    got = th.merge(stack, TPeerModel(stack.params + 1.0,
                                     stack.n_updates + 2))
    assert all(torch.equal(a, b) for a, b in zip(got.opt_state,
                                                  stack.opt_state))


@pytest.mark.parametrize("mode", [CreateModelMode.UPDATE,
                                  CreateModelMode.MERGE_UPDATE,
                                  CreateModelMode.UPDATE_MERGE,
                                  CreateModelMode.PASS])
def test_call_trains_with_the_receivers_opt_state(mode):
    """Momentum from random state: the received model trains (and PASS
    keeps) the receiving node's own optimizer state, as the JAX ``call``
    does; everything within 1e-5."""
    X, y, mask = shards()
    kw = dict(local_epochs=1, batch_size=4, n_classes=2, input_shape=(D,),
              create_model_mode=mode)
    jh = SGDHandler(model=LogisticRegression(D, 2), loss=losses.cross_entropy,
                    optimizer=optax.sgd(0.3, momentum=0.9), **kw)
    th = TSGDHandler(TLogReg(D, 2), tlosses.cross_entropy,
                     optimizer=optim.sgd(0.3, momentum=0.9), **kw)
    own, peer = jax_state(jh, 1), jax_state(jh, 2)
    keys = jax.random.split(jax.random.PRNGKey(9), N)
    want = jax.vmap(jh.call)(own, JPeerModel(peer.params, peer.n_updates),
                             (jnp.asarray(X), jnp.asarray(y),
                              jnp.asarray(mask)), keys)
    split = mode == CreateModelMode.UPDATE_MERGE
    perms = torch.from_numpy(perms_from_keys(keys, 1, S, split)).long()
    p = port_state(th, peer)
    got = th.call(port_state(th, own), TPeerModel(p.params, p.n_updates),
                  port_data(X, y, mask), perms)
    assert_state_close(th, got, want)


@pytest.mark.parametrize("epochs,batch", [(2, 0), (0, 4), (0, 16)])
def test_full_batch_and_single_step_match_jax(epochs, batch):
    """``batch_size=0``: each epoch is one step on the whole shard;
    ``local_epochs=0``: one step on ``batch_size`` rows of the order the
    node's key draws (all ``S`` when the batch is larger)."""
    X, y, mask = shards()
    kw = dict(local_epochs=epochs, batch_size=batch, n_classes=2,
              input_shape=(D,))
    jh = SGDHandler(model=LogisticRegression(D, 2), loss=losses.cross_entropy,
                    optimizer=optax.sgd(0.3, momentum=0.5), **kw)
    th = TSGDHandler(TLogReg(D, 2), tlosses.cross_entropy,
                     optimizer=optim.sgd(0.3, momentum=0.5), **kw)
    jst = jax_state(jh, 4)
    keys = jax.random.split(jax.random.PRNGKey(7), N)
    want = jax.vmap(jh.update)(jst, (jnp.asarray(X), jnp.asarray(y),
                                     jnp.asarray(mask)), keys)
    perms = torch.from_numpy(perms_from_keys(keys, epochs, S)).long()
    assert perms.shape == (N, max(epochs, 1), S)
    got = th.update(port_state(th, jst), port_data(X, y, mask), perms)
    assert_state_close(th, got, want)
    steps = (got.n_updates - port_state(th, jst).n_updates).tolist()
    assert steps[0] == max(epochs, 1) and steps[3] == 0


def test_full_batch_needs_an_epoch():
    for bad in (dict(batch_size=0, local_epochs=0),
                dict(batch_size=-1), dict(local_epochs=-1)):
        with pytest.raises(ValueError, match="batch_size"):
            TSGDHandler(TLogReg(D, 2), tlosses.cross_entropy,
                        input_shape=(D,), **bad)


def cifar_shards(n=3, s=12):
    rng = np.random.default_rng(8)
    X = rng.normal(size=(n, s, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, (n, s))
    mask = np.ones((n, s), np.float32)
    mask[2, 5:] = 0.0
    return X, y, mask


def cifar_pair(compute, remat=False, batch=8):
    """The flagship's handler (CIFAR10Net, weight decay 1e-3 and SGD
    0.05) in both packages."""
    kw = dict(local_epochs=1, batch_size=batch, n_classes=10,
              input_shape=(32, 32, 3))
    jh = SGDHandler(model=CIFAR10Net(), loss=losses.cross_entropy,
                    optimizer=optax.chain(optax.add_decayed_weights(1e-3),
                                          optax.sgd(0.05)),
                    compute_dtype=None if compute == "fp32"
                    else jnp.bfloat16, remat=remat, **kw)
    th = TSGDHandler(TCIFAR10Net(), tlosses.cross_entropy,
                     optimizer=optim.chain(optim.add_decayed_weights(1e-3),
                                           optim.sgd(0.05)),
                     compute_dtype=None if compute == "fp32"
                     else torch.bfloat16, remat=remat, **kw)
    return jh, th


def cifar_update(jh, th):
    X, y, mask = cifar_shards()
    n, s = mask.shape
    jst = jax.vmap(jh.init)(jax.random.split(jax.random.PRNGKey(3), n))
    keys = jax.random.split(jax.random.PRNGKey(5), n)
    want = jax.vmap(jh.update)(jst, (jnp.asarray(X), jnp.asarray(y),
                                     jnp.asarray(mask)), keys)
    perms = torch.from_numpy(perms_from_keys(keys, 1, s)).long()
    got = th.update(port_state(th, jst), port_data(X, y, mask), perms)
    start = port_state(th, jst)
    return got, want, start, (X, y, mask)


def test_cifar_update_fp32_matches_jax():
    """The flagship's update (two batches of 8, the second wrapping) at
    CIFAR10Net's full width: params within 1e-5."""
    jh, th = cifar_pair("fp32")
    got, want, _, _ = cifar_update(jh, th)
    assert_state_close(th, got, want)


def flat_jax(tree) -> np.ndarray:
    return np.concatenate([np.asarray(v).ravel() for _, v in
                           sorted(convert.flatten_names(tree).items())])


def within_bf16_effect(got, want, want32, share=0.5):
    """The rule for bfloat16 compute: the two frameworks round the bf16
    sums and bias adds in other places (and a ReLU or max-pool decision
    near a tie can go the other way), so they are held to the size of
    bf16's own effect. The port's result must lie within ``share`` of the
    distance between the reference's bf16 and fp32 results, in its
    largest element and in its median one."""
    diff = np.abs(got - want)
    effect = np.abs(want - want32)
    assert np.median(effect) > 0 and effect.max() > 1e-5
    assert diff.max() <= share * effect.max(), (diff.max(), effect.max())
    assert np.median(diff) <= share * np.median(effect), \
        (np.median(diff), np.median(effect))


def test_cifar_update_bf16_matches_jax():
    """bfloat16 compute: params and inputs cast for the forward and
    backward passes, scores back to float32, master params float32; held
    by :func:`within_bf16_effect` (the port's bf16 update against JAX's,
    beside JAX's fp32 update) and ages exactly."""
    jh, th = cifar_pair("bf16")
    got, want, _, _ = cifar_update(jh, th)
    assert got.params.dtype == torch.float32
    _, want32, _, _ = cifar_update(*cifar_pair("fp32"))
    views = convert.params_to_numpy(got.params, th.layout)
    within_bf16_effect(np.concatenate([views[k].ravel()
                                       for k in sorted(views)]),
                       flat_jax(want.params), flat_jax(want32.params))
    np.testing.assert_array_equal(got.n_updates.numpy(),
                                  np.asarray(want.n_updates))
    scores = th.apply(got.params, port_data(*cifar_shards())[0][:, :2])
    assert scores.dtype == torch.float32


def test_remat_changes_nothing():
    """``remat`` recomputes the forward in the backward pass: the port's
    update is bit-equal with and without it, and within 1e-5 of JAX's
    (``jax.checkpoint``)."""
    jh, th = cifar_pair("fp32", remat=True)
    got, want, start, data = cifar_update(jh, th)
    assert_state_close(th, got, want)
    _, plain = cifar_pair("fp32")
    n, s = data[2].shape
    keys = jax.random.split(jax.random.PRNGKey(5), n)
    perms = torch.from_numpy(perms_from_keys(keys, 1, s)).long()
    again = plain.update(start, port_data(*data), perms)
    assert torch.equal(again.params, got.params)
