"""The baseline twin, the scikit-learn built-ins, and the root's
``GlobalSettings`` and ``DuplicateFilter``.

- The centralized MLP of ``examples/baseline.py`` (``flax_mlp``: MLP(d,
  2, hidden_dims=(100,)) through ``SGDHandler`` with ``chain(
  add_decayed_weights(1e-3), sgd(0.01))``, batch 16) against the port's
  ``torch_mlp`` for 2 epochs, from the JAX init carried by ``convert.py``
  and the JAX shard orders (``torch_oracle.perms_from_keys``): params
  within 1e-5 plus 1e-5 of their magnitude (float32 reduction order
  differs), every eval metric within 1e-4.
- The twin's JSON line: the JAX script's keys; with scikit-learn blocked
  its half is null with the reason, the port's half still runs.
- iris, breast_cancer, digits and wine: the port's arrays equal the JAX
  loader's, scaled or not.
- ``GlobalSettings`` and ``DuplicateFilter`` behave as the JAX ones do;
  ``resolve_device`` reads the settings' device, and nothing falls back
  to the CPU without a card.
"""

import importlib.util
import json
import logging
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import gossipy_tpu
import gossipy_tpu_torch
from gossipy_tpu.data import ClassificationDataHandler as JDataHandler
from gossipy_tpu.data import load_classification_dataset as jload
from gossipy_tpu_torch import convert
from gossipy_tpu_torch import data as tdata
from gossipy_tpu_torch.examples import baseline
from gossipy_tpu_torch.handlers.base import ModelState
from torch_oracle import perms_from_keys

REPO = Path(__file__).resolve().parents[1]
EPOCHS = 2


@pytest.fixture(scope="module")
def jax_baseline():
    """``examples/baseline.py`` loaded with a stand-in for its
    ``_common`` (the real one turns on JAX's compilation cache under
    HOME)."""
    common = types.ModuleType("_common")
    common.make_parser = lambda *a, **k: None
    saved = sys.modules.get("_common")
    sys.modules["_common"] = common
    try:
        spec = importlib.util.spec_from_file_location(
            "_jax_examples_baseline", REPO / "examples" / "baseline.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        if saved is None:
            sys.modules.pop("_common")
        else:
            sys.modules["_common"] = saved
    return mod


@pytest.fixture(scope="module")
def handlers():
    X, y = tdata.load_classification_dataset("spambase")
    return (JDataHandler(X, y, test_size=0.1, seed=42),
            tdata.ClassificationDataHandler(X, y, test_size=0.1, seed=42))


def test_mlp_matches_flax_mlp(jax_baseline, handlers):
    import optax

    from gossipy_tpu.handlers import SGDHandler, losses
    from gossipy_tpu.models import MLP
    jdh, tdh = handlers
    np.testing.assert_array_equal(np.asarray(jdh.get_train_set()[0]),
                                  np.asarray(tdh.get_train_set()[0]))
    want = jax_baseline.flax_mlp(jdh, n_epochs=EPOCHS, seed=42)
    # flax_mlp's own state, made as it makes it.
    d = jdh.size(1)
    jh = SGDHandler(model=MLP(d, 2, hidden_dims=(100,)),
                    loss=losses.cross_entropy,
                    optimizer=optax.chain(optax.add_decayed_weights(0.001),
                                          optax.sgd(0.01)),
                    local_epochs=EPOCHS, batch_size=16, n_classes=2,
                    input_shape=(d,))
    key = jax.random.PRNGKey(42)
    j0 = jh.init(key)
    Xtr, ytr = jdh.get_train_set()
    j1 = jax.jit(jh.update)(j0, (Xtr, ytr, np.ones(len(Xtr), np.float32)),
                            key)
    layout = baseline.mlp_handler(d, EPOCHS).layout
    rule = baseline.mlp_handler(d, EPOCHS).optimizer
    state = ModelState(
        convert.params_from_jax(jax.tree.map(np.asarray, j0.params), layout,
                                stacked=False)[None],
        convert.opt_state_from_jax(jax.tree.map(np.asarray, j0.opt_state),
                                   layout, rule, stacked=False),
        torch.as_tensor(np.asarray(j0.n_updates))[None])
    perms = torch.as_tensor(perms_from_keys(np.asarray(key)[None], EPOCHS,
                                            len(Xtr)))
    got = baseline.torch_mlp(tdh, n_epochs=EPOCHS, seed=42, device="cpu",
                             state=state, perms=perms)
    trained = got.pop("_state")
    want_p = convert.params_from_jax(jax.tree.map(np.asarray, j1.params),
                                     layout, stacked=False).numpy()
    got_p = trained.params[0].numpy()
    np.testing.assert_allclose(got_p, want_p, rtol=1e-5, atol=1e-5)
    assert int(trained.n_updates[0]) == int(j1.n_updates)
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    assert got["accuracy"] > 0.8


def test_twin_prints_the_jax_keys_without_sklearn(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.metrics", None)
    monkeypatch.setitem(sys.modules, "sklearn.neural_network", None)
    out = baseline.main(["--device", "cpu", "--rounds", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert out["sklearn_mlp"] is None
    assert "scikit-learn" in out["sklearn_mlp_skipped"]
    assert out["flax_mlp"]["accuracy"] > 0.7
    jkeys = {"flax_mlp", "sklearn_mlp"}
    assert set(out) == jkeys | {"sklearn_mlp_skipped"}


def test_twin_runs_the_sklearn_half_where_it_imports(handlers):
    pytest.importorskip("sklearn")
    out = baseline.sklearn_mlp(handlers[1], n_epochs=2)
    assert sorted(out) == ["accuracy", "auc"]
    assert 0.5 < out["accuracy"] <= 1.0


@pytest.mark.parametrize("name", ["iris", "breast", "breast_cancer",
                                  "digits", "wine"])
@pytest.mark.parametrize("normalize", [False, True])
def test_sklearn_builtins_equal_the_jax_loader(name, normalize):
    Xj, yj = jload(name, normalize=normalize)
    Xt, yt = tdata.load_classification_dataset(name, normalize=normalize)
    assert Xt.dtype == Xj.dtype == np.float32
    assert yt.dtype == yj.dtype == np.int64
    np.testing.assert_array_equal(yt, yj)
    if normalize:
        # The port's numpy StandardScaler against scikit-learn's.
        np.testing.assert_allclose(Xt, Xj, rtol=0, atol=1e-5)
    else:
        np.testing.assert_array_equal(Xt, Xj)


# -- GlobalSettings and DuplicateFilter ------------------------------------

@pytest.fixture
def settings():
    s = gossipy_tpu_torch.GlobalSettings()
    saved = s._device
    yield s
    s._device = saved


def test_global_settings_is_a_singleton_like_the_jax_one(settings):
    assert gossipy_tpu_torch.GlobalSettings() is settings
    assert gossipy_tpu.GlobalSettings() is gossipy_tpu.GlobalSettings()
    assert settings.get_device() == "cuda"
    settings.set_device("cpu")
    assert gossipy_tpu_torch.GlobalSettings().get_device() == "cpu"
    settings.set_device(None)
    assert settings.get_device() == "cuda"
    with pytest.raises(ValueError):
        settings.set_device("tpu")


def test_resolve_device_reads_the_settings(settings):
    settings.set_device("cpu")
    assert gossipy_tpu_torch.resolve_device() == torch.device("cpu")
    assert gossipy_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    settings.set_device(None)
    if not torch.cuda.is_available():
        # No card: the default raises, it never falls back to the CPU.
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gossipy_tpu_torch.resolve_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            settings.auto_device()
        assert settings.get_device() == "cuda"


def test_an_entry_point_runs_on_the_named_host(settings):
    settings.set_device("cpu")
    from gossipy_tpu_torch.analysis import program
    sim = program._make_sim(device=None)
    assert sim.device == torch.device("cpu")


def test_duplicate_filter_behaves_like_the_jax_one():
    def feed(flt):
        out = []
        for msg in ("a", "b", "a", "c %s", "b"):
            rec = logging.LogRecord("x", logging.INFO, __file__, 1, msg,
                                    ("1",) if "%s" in msg else None, None)
            out.append(flt.filter(rec))
        rec = logging.LogRecord("x", logging.INFO, __file__, 1, "c %s",
                                ("2",), None)
        out.append(flt.filter(rec))
        return out
    assert feed(gossipy_tpu_torch.DuplicateFilter()) == \
        feed(gossipy_tpu.DuplicateFilter()) == [True, True, False, True,
                                                 False, True]
    assert any(isinstance(f, gossipy_tpu_torch.DuplicateFilter)
               for f in gossipy_tpu_torch.LOG.filters)
    assert gossipy_tpu_torch.LOG.name == "gossipy_tpu_torch"
