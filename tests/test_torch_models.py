"""The port's models and loss against the JAX package's.

Forwards run on parameters converted from a flax init (two nodes, three
inputs each, each node its own weights). Tolerance 1e-5: the im2col
products reduce in another order than XLA's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipy_tpu.handlers import losses
from gossipy_tpu.models import MLP, CIFAR10Net, LinearRegression, \
    LogisticRegression, Perceptron
from gossipy_tpu_torch import convert
from gossipy_tpu_torch.handlers import losses as tlosses
from gossipy_tpu_torch.models import CIFAR10Net as TCIFAR10Net
from gossipy_tpu_torch.models import MLP as TMLP
from gossipy_tpu_torch.models import LinearRegression as TLinReg
from gossipy_tpu_torch.models import LogisticRegression as TLogReg
from gossipy_tpu_torch.models import Perceptron as TPerceptron
from gossipy_tpu_torch.models import ParamLayout

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def stacked_init(model, x_shape, n=2):
    keys = jax.random.split(jax.random.PRNGKey(4), n)
    dummy = jnp.zeros((1,) + x_shape, jnp.float32)
    return jax.vmap(lambda k: model.init(k, dummy)["params"])(keys)


def run_both(jmodel, tmodel, x):
    """x: numpy [N, B, ...]; returns (port, JAX) forwards."""
    jparams = stacked_init(jmodel, x.shape[2:], n=x.shape[0])
    want = jax.vmap(lambda p, xb: jmodel.apply({"params": p}, xb))(
        jparams, jnp.asarray(x))
    layout = ParamLayout(tmodel.leaves)
    flat = convert.params_from_jax(jax.tree.map(np.asarray, jparams), layout)
    got = tmodel.forward(layout.views(flat), torch.from_numpy(x))
    return got.detach().numpy(), np.asarray(want)


def test_logistic_regression_forward():
    x = np.random.default_rng(0).normal(size=(2, 3, 7)).astype(np.float32)
    got, want = run_both(LogisticRegression(7, 2), TLogReg(7, 2), x)
    assert got.shape == (2, 3, 2)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_cifar10net_forward(layout):
    x = np.random.default_rng(1).normal(size=(2, 3, 32, 32, 3)) \
        .astype(np.float32)
    jparams = stacked_init(CIFAR10Net(), (32, 32, 3))
    want = np.asarray(jax.vmap(
        lambda p, xb: CIFAR10Net().apply({"params": p}, xb))(
            jparams, jnp.asarray(x)))
    tmodel = TCIFAR10Net()
    lay = ParamLayout(tmodel.leaves)
    flat = convert.params_from_jax(jax.tree.map(np.asarray, jparams), lay)
    xin = x if layout == "nhwc" else np.ascontiguousarray(
        x.transpose(0, 1, 4, 2, 3))
    got = tmodel.forward(lay.views(flat), torch.from_numpy(xin)).numpy()
    assert got.shape == (2, 3, 10)
    np.testing.assert_allclose(got, want, **TOL)


def test_cifar10net_leaves_match_flax_tree():
    jparams = CIFAR10Net().init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 32, 32, 3)))["params"]
    want = {n: tuple(np.shape(v)) for n, v in
            convert.flatten_names(jax.tree.map(np.asarray, jparams)).items()}
    assert dict(TCIFAR10Net().leaves) == want
    lay = ParamLayout(TCIFAR10Net().leaves)
    assert lay.width == 73418 and lay.stride % 4 == 0


def test_layout_round_trip_and_padding():
    lay = ParamLayout(TCIFAR10Net().leaves)
    rng = np.random.default_rng(2)
    leaves = {n: torch.from_numpy(rng.normal(size=(3,) + s).astype(np.float32))
              for n, s in lay.leaves}
    flat = lay.flatten(leaves)
    assert flat.shape == (3, lay.stride)
    assert (flat[:, lay.width:] == 0).all()
    for n, v in lay.views(flat).items():
        np.testing.assert_array_equal(v.numpy(), leaves[n].numpy())


def test_convert_rejects_wrong_tree():
    lay = ParamLayout(TLogReg(7, 2).leaves)
    good = {"Dense_0": {"kernel": np.zeros((2, 7, 2), np.float32),
                        "bias": np.zeros((2, 2), np.float32)}}
    assert convert.params_from_jax(good, lay).shape == (2, lay.stride)
    with pytest.raises(ValueError, match="names"):
        convert.params_from_jax({"Dense_1": good["Dense_0"]}, lay)
    bad = {"Dense_0": dict(good["Dense_0"],
                           kernel=np.zeros((2, 2, 7), np.float32))}
    with pytest.raises(ValueError, match="shape"):
        convert.params_from_jax(bad, lay)


@pytest.mark.parametrize("labels", ["int", "onehot"])
@pytest.mark.parametrize("mask_kind", ["partial", "empty", "none"])
def test_cross_entropy_value_and_gradient(labels, mask_kind):
    rng = np.random.default_rng(3)
    scores = rng.normal(size=(6, 4)).astype(np.float32)
    y = rng.integers(0, 4, 6)
    if labels == "onehot":
        y = np.eye(4, dtype=np.float32)[y]
    mask = {"partial": np.array([1, 1, 0, 1, 0, 1], np.float32),
            "empty": np.zeros(6, np.float32), "none": None}[mask_kind]
    jm = None if mask is None else jnp.asarray(mask)
    want, want_g = jax.value_and_grad(
        lambda s: losses.cross_entropy(s, jnp.asarray(y), jm))(
            jnp.asarray(scores))
    s = torch.from_numpy(scores).requires_grad_(True)
    tm = None if mask is None else torch.from_numpy(mask)
    got = tlosses.cross_entropy(s, torch.from_numpy(y), tm)
    (got_g,) = torch.autograd.grad(got, s)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **TOL)
    if mask_kind == "empty":
        assert got.item() == 0.0 and not got_g.any()


def small_models(d):
    """(flax model, port model) pairs of the dense models, input dim d."""
    return {
        "perceptron": (Perceptron(d), TPerceptron(d)),
        "perceptron-nobias": (Perceptron(d, use_bias=False),
                              TPerceptron(d, use_bias=False)),
        "mlp": (MLP(d, 3, hidden_dims=(5, 4)),
                TMLP(d, 3, hidden_dims=(5, 4))),
        "linreg": (LinearRegression(d, 2), TLinReg(d, 2)),
    }


@pytest.mark.parametrize("name", ["perceptron", "perceptron-nobias", "mlp",
                                  "linreg"])
def test_dense_model_forward_and_leaves(name):
    """Perceptron (sigmoid, one output), MLP (ReLU hidden layers, raw
    scores) and LinearRegression on converted flax weights, two nodes;
    the port's leaves are the flax tree's."""
    jmodel, tmodel = small_models(7)[name]
    jp = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 7)))["params"]
    want = {n: tuple(np.shape(v)) for n, v in
            convert.flatten_names(jax.tree.map(np.asarray, jp)).items()}
    assert dict(tmodel.leaves) == want
    x = np.random.default_rng(5).normal(size=(2, 3, 7)).astype(np.float32)
    got, want = run_both(jmodel, tmodel, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("which", ["logreg", "cifar", "perceptron", "mlp",
                                   "linreg"])
def test_init_distributions_match_flax(which):
    """The port draws its own initial weights (a torch.Generator cannot
    replay flax's keys); each leaf's scale matches flax's initialiser
    (xavier-uniform where the flax model names it, lecun-normal for a
    plain ``Dense``, zero biases)."""
    if which == "logreg":
        jmodel, tmodel, shape = LogisticRegression(300, 40), TLogReg(300, 40), (300,)
    elif which == "cifar":
        jmodel, tmodel, shape = CIFAR10Net(), TCIFAR10Net(), (32, 32, 3)
    elif which == "perceptron":
        jmodel, tmodel, shape = Perceptron(300), TPerceptron(300), (300,)
    elif which == "mlp":
        jmodel, tmodel, shape = (MLP(300, 40, hidden_dims=(200,)),
                                 TMLP(300, 40, hidden_dims=(200,)), (300,))
    else:
        jmodel, tmodel, shape = LinearRegression(300, 40), TLinReg(300, 40), (300,)
    jp = convert.flatten_names(jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + shape))["params"]))
    tp = tmodel.init(torch.Generator().manual_seed(0))
    assert sorted(tp) == sorted(jp)
    for name, want in jp.items():
        got = tp[name].numpy()
        assert got.shape == want.shape, name
        if name.endswith("bias"):
            assert not got.any() and not want.any(), name
            continue
        np.testing.assert_allclose(got.std(), want.std(), rtol=0.1,
                                   err_msg=name)
        np.testing.assert_allclose(np.abs(got).max(), np.abs(want).max(),
                                   rtol=0.15, err_msg=name)


# ``_lecun_normal((57, 2), 57, torch.Generator().manual_seed(0))``: its
# first six values as float32 bit patterns (the north star's LogReg
# kernel). ``chip_smoke.LECUN_PIN`` holds the same values, which the card's
# torch must give too.
LECUN_BITS = (1048290957, 1033913533, 3161465076, 1044841987, 1029340760,
              1038873588)


def test_lecun_normal_pinned():
    """The truncated normal is drawn in the module (inverse CDF over one
    float64 uniform each), not by the torch release's sampler: pinned
    values at a fixed seed and shape, equal to what chip_smoke checks on
    the card; every value within two standard deviations; the variance
    ``1 / fan_in`` within sampling error; ``trunc_normal_`` never
    called."""
    import math

    import chip_smoke
    from gossipy_tpu_torch.models import nn as tnn
    seed, shape = chip_smoke.LECUN_PIN["seed"], chip_smoke.LECUN_PIN["shape"]
    assert (seed, shape) == (0, (57, 2))
    x = tnn._lecun_normal(shape, shape[0], torch.Generator().manual_seed(seed))
    assert x.dtype == torch.float32 and x.shape == shape
    bits = tuple(x.flatten()[:6].numpy().view(np.uint32).tolist())
    assert bits == LECUN_BITS == chip_smoke.LECUN_PIN["bits"]
    fan_in, n = 40, 200_000
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    y = tnn._lecun_normal((n,), fan_in, torch.Generator().manual_seed(1))
    assert float(y.abs().max()) <= 2 * std
    var = float(y.double().var())
    # The variance estimate's standard error is ~ sqrt(2 / n) var (less
    # for the truncated normal); 5 of them.
    assert abs(var * fan_in - 1.0) < 5 * math.sqrt(2.0 / n)
    assert "trunc_normal_" not in open(tnn.__file__).read()


def test_param_count():
    from gossipy_tpu.models import param_count as jcount
    from gossipy_tpu_torch.models import param_count
    for jmodel, tmodel, shape in (
            (LogisticRegression(57, 2), TLogReg(57, 2), (57,)),
            (CIFAR10Net(), TCIFAR10Net(), (32, 32, 3))):
        want = jcount(jmodel.init(jax.random.PRNGKey(0),
                                  jnp.zeros((1,) + shape))["params"])
        tp = tmodel.init(torch.Generator().manual_seed(0))
        layout = ParamLayout(tmodel.leaves)
        assert param_count(tp) == layout.width == want


@pytest.mark.parametrize("loss", ["mse", "binary_cross_entropy"])
@pytest.mark.parametrize("mask_kind", ["partial", "empty", "none"])
def test_regression_and_binary_losses(loss, mask_kind):
    """``mse`` (one-column labels and full targets) and
    ``binary_cross_entropy`` (probability outputs ``[B, 1]``, clipped away
    from 0 and 1): values and gradients."""
    rng = np.random.default_rng(4)
    if loss == "mse":
        cases = [(rng.normal(size=(6, 1)), rng.normal(size=6)),
                 (rng.normal(size=(6, 3)), rng.normal(size=(6, 3)))]
    else:
        p = rng.uniform(0.05, 0.95, size=(6, 1))
        p[0, 0] = 1.0   # clipped
        cases = [(p, rng.integers(0, 2, 6)), (p[:, 0], rng.integers(0, 2, 6))]
    mask = {"partial": np.array([1, 1, 0, 1, 0, 1], np.float32),
            "empty": np.zeros(6, np.float32), "none": None}[mask_kind]
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    for scores, y in cases:
        scores = scores.astype(np.float32)
        y = y.astype(np.float32 if loss == "mse" else np.int64)
        want, want_g = jax.value_and_grad(
            lambda sc: getattr(losses, loss)(sc, jnp.asarray(y), jm))(
                jnp.asarray(scores))
        sc = torch.from_numpy(scores).requires_grad_(True)
        got = getattr(tlosses, loss)(sc, torch.from_numpy(y), tm)
        (got_g,) = torch.autograd.grad(got, sc)
        np.testing.assert_allclose(got.item(), float(want), **TOL)
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **TOL)
