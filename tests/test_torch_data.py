"""The port's offline classification loader against the JAX package's
offline path: its synthetic stand-in (generator and version) followed by
scikit-learn's ``StandardScaler``. The JAX loader itself is not called: it
tries a download first."""

import os
import warnings

import numpy as np
import pytest
from sklearn.preprocessing import StandardScaler

from gossipy_tpu import data as jdata
from gossipy_tpu_torch import data as tdata


def test_constants_match_jax():
    assert tdata.UCI_SHAPES == jdata.UCI_SHAPES
    assert tdata.SYNTHETIC_DATA_VERSION == jdata.SYNTHETIC_DATA_VERSION


@pytest.mark.parametrize("name", ["spambase", "abalone", "sonar"])
def test_loader_matches_jax_offline_path(name):
    n, d, c = jdata.UCI_SHAPES[name]
    Xj, yj = jdata._synthetic_classification(name, n, d, c)
    with pytest.warns(UserWarning, match="synthetic stand-in"):
        Xr, yr = tdata.load_classification_dataset(name, normalize=False)
    np.testing.assert_array_equal(Xr, Xj)
    np.testing.assert_array_equal(yr, yj)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        X, y = tdata.load_classification_dataset(name.upper())
    want = StandardScaler().fit_transform(Xj).astype(np.float32)
    assert X.dtype == np.float32 and y.dtype == np.int64
    np.testing.assert_array_equal(y, yj)
    np.testing.assert_allclose(X, want, rtol=0, atol=1e-6)


def test_standard_scale_zero_std_column():
    """A constant column (exactly, and within rounding of its mean) keeps
    scale 1, as ``StandardScaler``'s does."""
    rng = np.random.default_rng(0)
    X = rng.normal(3.0, 2.0, size=(301, 4)).astype(np.float32)
    X[:, 1] = 0.1
    X[:, 3] = 7.0
    got = tdata.standard_scale(X)
    want = StandardScaler().fit_transform(X).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got[:, [1, 3]]).max() < 1e-6
    np.testing.assert_allclose(got[:, [0, 2]].std(axis=0), 1.0, atol=1e-5)


@pytest.mark.parametrize("name", ["iris", "breast", "digits", "wine"])
def test_sklearn_builtins_raise(name, monkeypatch):
    """Without scikit-learn (the card's machine has none) a built-in
    raises an ImportError that names it; with it, it loads
    (tests/test_torch_baseline.py holds the arrays to the JAX loader's)."""
    import sys
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        tdata.load_classification_dataset(name)


def test_svmlight_file_and_unknown_name_raise(tmp_path):
    """An svmlight file loads through the port's numpy reader as the JAX
    package loads it through scikit-learn's (one-based indices, a
    comment, a ``qid`` token, labels encoded in sorted order; the
    features scaled); an unknown name raises."""
    from gossipy_tpu.data import load_classification_dataset as jload
    path = tmp_path / "train.dat"
    path.write_text("1 1:0.5 3:2.0 # a comment\n-1 qid:3 2:1.5\n\n"
                    "+1 1:-0.25 4:1\n2 2:0.75 3:-1\n")
    for normalize in (False, True):
        X, y = tdata.load_classification_dataset(os.fspath(path),
                                                 normalize=normalize)
        jX, jy = jload(os.fspath(path), normalize=normalize)
        assert X.dtype == jX.dtype and y.dtype == jy.dtype
        np.testing.assert_allclose(X, jX, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(y, jy)
    path.write_text("1 3:1 2:1\n")
    for load in (tdata.load_classification_dataset, jload):
        with pytest.raises(ValueError, match="sorted and unique"):
            load(os.fspath(path))
    with pytest.raises(ValueError, match="Unknown dataset"):
        tdata.load_classification_dataset("no-such-dataset")


PARTITIONERS = {
    "uniform": {},
    "quantity_skew": {"min_quantity": 2, "alpha": 4.0},
    "classwise_quantity_skew": {"min_quantity": 2, "alpha": 3.0},
    "label_quantity_skew": {"class_per_client": 2},
    "label_dirichlet_skew": {"beta": 0.5},
    "label_pathological_skew": {"shards_per_client": 2},
}


@pytest.mark.parametrize("name", list(PARTITIONERS))
@pytest.mark.parametrize("seed", [0, 7, 42])
def test_partitioners_match_jax(name, seed):
    """The same seed gives the same index arrays, node for node."""
    y = np.random.default_rng(5).integers(0, 10, 600)
    kw = PARTITIONERS[name]
    want = getattr(jdata.AssignmentHandler(seed), name)(y, 12, **kw)
    got = getattr(tdata.AssignmentHandler(seed), name)(y, 12, **kw)
    assert len(got) == len(want) == 12
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_partitioner_checks_raise():
    h = tdata.AssignmentHandler(0)
    y = np.arange(20) % 4
    with pytest.raises(ValueError, match="beta"):
        h.label_dirichlet_skew(y, 3, beta=0.0)
    with pytest.raises(ValueError, match="min_quantity"):
        h.quantity_skew(y, 30)
    with pytest.raises(ValueError, match="class_per_client"):
        h.label_quantity_skew(y, 3, class_per_client=5)
    with pytest.raises(ValueError, match="Under represented"):
        h.classwise_quantity_skew(y, 6, min_quantity=1)


def test_dispatcher_dirichlet_and_set_assignments():
    """The flagship's dispatcher (a Dirichlet split, re-assigned with the
    run's seed) stacks as the JAX one does; ``set_assignments`` installs
    custom splits."""
    rng = np.random.default_rng(2)
    X = rng.normal(size=(300, 4, 4, 3)).astype(np.float32)
    y = rng.integers(0, 10, 300)
    Xte, yte = X[:40], y[:40]
    out = []
    for pkg in (jdata, tdata):
        d = pkg.DataDispatcher(
            pkg.ClassificationDataHandler(X, y, Xte, yte), n=8,
            eval_on_user=False,
            assignment=pkg.AssignmentHandler.label_dirichlet_skew, beta=0.5)
        d.assign(3)
        a = d.stacked()
        d.set_assignments([np.arange(i, i + 5) for i in range(8)])
        out.append((a, d.stacked(), d[2]))
    (a, b, node), (ta, tb, tnode) = out
    for want, got in ((a, ta), (b, tb)):
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tb["xtr"].shape[1] == 5 and tnode[1] is None
    np.testing.assert_array_equal(tnode[0][1], node[0][1])
    with pytest.raises(ValueError, match="8 nodes"):
        tdata.DataDispatcher(tdata.ClassificationDataHandler(X, y), n=8,
                             auto_assign=False).set_assignments([[0]])


@pytest.mark.parametrize("name,n", [("cifar10-train", 300),
                                    ("cifar10-test", 70)])
def test_synthetic_images_match_jax(name, n):
    Xj, yj = jdata._synthetic_images(name, n, (32, 32, 3), 10)
    Xt, yt = tdata._synthetic_images(name, n, (32, 32, 3), 10)
    assert Xt.dtype == np.float32 and yt.dtype == np.int64
    np.testing.assert_array_equal(Xt, Xj)
    np.testing.assert_array_equal(yt, yj)


def test_get_cifar10_is_the_synthetic_set(monkeypatch):
    """``get_CIFAR10`` gives ``_synthetic_images`` of the JAX fallback's
    names and sizes (checked by the call, not by building 60,000 images
    here), warns, and with ``allow_synthetic=False`` raises, naming the
    archive. The JAX ``get_CIFAR10`` is never called: it tries a
    download."""
    calls = []
    real = tdata._synthetic_images

    def fake(name, n, shape, c):
        calls.append((name, n, shape, c))
        return real(name, 4, shape, c)
    monkeypatch.setattr(tdata, "_synthetic_images", fake)
    with pytest.warns(UserWarning, match="synthetic"):
        (Xtr, ytr), (Xte, yte) = tdata.get_CIFAR10()
    assert calls == [("cifar10-train", 50_000, (32, 32, 3), 10),
                     ("cifar10-test", 10_000, (32, 32, 3), 10)]
    np.testing.assert_array_equal(
        Xtr, jdata._synthetic_images("cifar10-train", 4, (32, 32, 3), 10)[0])
    with pytest.raises(FileNotFoundError, match="cifar-10-python.tar.gz"):
        tdata.get_CIFAR10(allow_synthetic=False)
