"""The port's linear learners against the JAX package's.

``AdaLineHandler`` and ``PegasosHandler`` run 5 nodes at once on the same
numpy inputs as ``jax.vmap`` of the JAX handler: ``update`` over padded
shards (masked samples in the middle and at the end, one node with none),
``merge``, ``evaluate`` and ``call``. The per-sample recurrences differ
only in the order of a dot product's sum: params within 1e-5, ages
exactly, metrics within 1e-6 (1e-5 after an update). ``AdaLine``'s bare
``[dim]`` vector crosses the converters as the one leaf ``""``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipy_tpu.core import CreateModelMode
from gossipy_tpu.handlers import AdaLineHandler, PegasosHandler
from gossipy_tpu.handlers.base import ModelState as JModelState
from gossipy_tpu.handlers.base import PeerModel as JPeerModel
from gossipy_tpu.models import AdaLine
from gossipy_tpu.utils import signed_binary_metrics
from gossipy_tpu_torch import convert
from gossipy_tpu_torch.core import CreateModelMode as TMode
from gossipy_tpu_torch.handlers import AdaLineHandler as TAdaLineHandler
from gossipy_tpu_torch.handlers import ModelState as TModelState
from gossipy_tpu_torch.handlers import PeerModel as TPeerModel
from gossipy_tpu_torch.handlers import PegasosHandler as TPegasosHandler
from gossipy_tpu_torch.models import AdaLine as TAdaLine
from gossipy_tpu_torch.utils import \
    signed_binary_metrics as tsigned_binary_metrics

torch.set_num_threads(1)

N, S, D = 5, 9, 7
HANDLERS = {"adaline": (AdaLineHandler, TAdaLineHandler, 0.05),
            "pegasos": (PegasosHandler, TPegasosHandler, 0.01)}


def shards(seed=3):
    """±1 float labels; node 0 full, node 1 with masked samples inside,
    node 2 one sample, node 3 none, node 4 the last two masked."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, S, D)).astype(np.float32)
    y = np.where(rng.random((N, S)) < 0.5, -1.0, 1.0).astype(np.float32)
    mask = np.ones((N, S), np.float32)
    mask[1, [2, 3, 6]] = 0.0
    mask[2, 1:] = 0.0
    mask[3] = 0.0
    mask[4, -2:] = 0.0
    return X, y, mask


def start_state(seed=4):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(N, D)).astype(np.float32)
    ages = rng.integers(0, 6, N).astype(np.int32)
    return w, ages


def pair(name, mode=CreateModelMode.UPDATE):
    jcls, tcls, lr = HANDLERS[name]
    return (jcls(AdaLine(D), lr, create_model_mode=mode),
            tcls(TAdaLine(D), lr, create_model_mode=TMode(int(mode))))


def port_state(th, w, ages):
    return TModelState(convert.params_from_jax(w, th.layout), (),
                       torch.from_numpy(ages))


def tensors(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def test_adaline_model_is_one_zero_leaf():
    th = TAdaLineHandler(TAdaLine(D), 0.1)
    assert th.layout.leaves == [("", (D,))]
    assert th.layout.stride == 8 and th.get_size() == D
    st = th.init(device="cpu")
    np.testing.assert_array_equal(st.params.numpy(), np.zeros(8, np.float32))
    np.testing.assert_array_equal(
        convert.params_to_numpy(st.params, th.layout)[""],
        np.asarray(AdaLine(D).init()))
    assert int(st.n_updates) == 0 and th.orders_per_update() is None
    assert convert.flatten_names(jnp.zeros(3)).keys() == {""}


@pytest.mark.parametrize("name", sorted(HANDLERS))
def test_update_matches_vmapped_jax_update(name):
    jh, th = pair(name)
    X, y, mask = shards()
    w, ages = start_state()
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    want = jax.vmap(jh.update)(JModelState(jnp.asarray(w), (),
                                           jnp.asarray(ages)),
                               (X, y, mask), keys)
    got = th.update(port_state(th, w, ages), tensors(X, y, mask))
    np.testing.assert_allclose(
        convert.params_to_numpy(got.params, th.layout)[""],
        np.asarray(want.params), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.n_updates.numpy(),
                                  np.asarray(want.n_updates))
    # Masked samples change nothing: node 3 keeps its state.
    np.testing.assert_array_equal(got.params[3, :D].numpy(), w[3])
    assert int(got.n_updates[3]) == ages[3]
    assert (got.params[:, D:] == 0).all()


@pytest.mark.parametrize("name", sorted(HANDLERS))
def test_merge_and_evaluate_match_jax(name):
    jh, th = pair(name)
    X, y, mask = shards(5)
    mask[3, :3] = 1.0   # every node has eval rows
    w, ages = start_state(6)
    pw, pages = start_state(7)
    want = jax.vmap(jh.merge)(
        JModelState(jnp.asarray(w), (), jnp.asarray(ages)),
        JPeerModel(jnp.asarray(pw), jnp.asarray(pages)))
    got = th.merge(port_state(th, w, ages),
                   TPeerModel(convert.params_from_jax(pw, th.layout),
                              torch.from_numpy(pages)))
    np.testing.assert_array_equal(
        convert.params_to_numpy(got.params, th.layout)[""],
        np.asarray(want.params))
    np.testing.assert_array_equal(got.n_updates.numpy(),
                                  np.asarray(want.n_updates))
    want_m = jax.vmap(jh.evaluate)(JModelState(jnp.asarray(w), (), None),
                                   (X, y, mask))
    got_m = th.evaluate(port_state(th, w, ages), tensors(X, y, mask))
    assert sorted(got_m) == sorted(want_m)
    for k in want_m:
        np.testing.assert_allclose(got_m[k].numpy(), np.asarray(want_m[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("mode", [CreateModelMode.MERGE_UPDATE,
                                  CreateModelMode.UPDATE_MERGE,
                                  CreateModelMode.UPDATE])
def test_pegasos_call_matches_jax(mode):
    jh, th = pair("pegasos", mode)
    X, y, mask = shards(8)
    w, ages = start_state(9)
    pw, pages = start_state(10)
    keys = jax.random.split(jax.random.PRNGKey(1), N)
    want = jax.vmap(jh.call)(
        JModelState(jnp.asarray(w), (), jnp.asarray(ages)),
        JPeerModel(jnp.asarray(pw), jnp.asarray(pages)), (X, y, mask), keys)
    got = th.call(port_state(th, w, ages),
                  TPeerModel(convert.params_from_jax(pw, th.layout),
                             torch.from_numpy(pages)),
                  tensors(X, y, mask), None)
    np.testing.assert_allclose(
        convert.params_to_numpy(got.params, th.layout)[""],
        np.asarray(want.params), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.n_updates.numpy(),
                                  np.asarray(want.n_updates))
    scores = th.evaluate(got, tensors(X, y, np.ones_like(mask)))
    assert np.isfinite(scores["accuracy"].numpy()).all()


def test_signed_binary_metrics_match_jax():
    rng = np.random.default_rng(11)
    scores = rng.normal(size=(4, 30)).astype(np.float32)
    scores[0, :5] = 0.0                 # ties at the decision boundary
    y = np.where(rng.random((4, 30)) < 0.4, -1.0, 1.0).astype(np.float32)
    y[3] = 1.0                          # one class absent: AUC 0.5
    mask = (rng.random((4, 30)) < 0.8).astype(np.float32)
    want = jax.vmap(signed_binary_metrics)(scores, y, mask)
    got = tsigned_binary_metrics(*tensors(scores, y, mask))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
