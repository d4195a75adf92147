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
def test_sklearn_builtins_raise(name):
    with pytest.raises(NotImplementedError, match="scikit-learn"):
        tdata.load_classification_dataset(name)


def test_svmlight_file_and_unknown_name_raise(tmp_path):
    path = tmp_path / "train.dat"
    path.write_text("1 1:0.5\n")
    with pytest.raises(NotImplementedError, match="svmlight"):
        tdata.load_classification_dataset(os.fspath(path))
    with pytest.raises(ValueError, match="Unknown dataset"):
        tdata.load_classification_dataset("no-such-dataset")
