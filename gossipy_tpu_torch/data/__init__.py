"""Data layer: the offline loaders, the partitioners, the shard
dispatcher, and the step that puts the stacked shards on the device.

A numpy copy of the parts of ``gossipy_tpu/data/__init__.py`` the ported
paths run (loading, assignment and stacking run once at set-up, on the
host, and give numpy arrays). :meth:`DataDispatcher.stacked` pads every node's shard to one length
and returns ``X [N, S, ...]``, ``y [N, S]`` and ``mask [N, S]`` (1.0 on real
rows); :func:`to_device` moves that dict onto the run's device.

:func:`load_classification_dataset` gives the UCI names the JAX package's
offline stand-in (its deterministic synthetic data, without trying the
download first) and scales the features with :func:`standard_scale`, a
numpy copy of scikit-learn's ``StandardScaler``; a file path loads as
svmlight through a numpy reader (:func:`load_svmlight`).
:func:`get_CIFAR10`, :func:`get_FashionMNIST` and :func:`get_FEMNIST`
give the JAX package's synthetic stand-ins (no download is tried, and no
archive is read). :func:`load_recsys_dataset` gives the JAX package's
synthetic MovieLens stand-in (no download is tried), which
:class:`RecSysDataDispatcher` stacks one user a node. The scikit-learn
built-ins (iris, breast_cancer, digits, wine) load from scikit-learn's
bundled data where scikit-learn is installed, and raise ``ImportError``
naming it where it is not (the card's machine has none).
"""

from __future__ import annotations

import os
import warnings
import zlib
from statistics import NormalDist
from typing import Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from .handler import ClassificationDataHandler, ClusteringDataHandler, \
    DataHandler, RecSysDataHandler, RegressionDataHandler

__all__ = ["AssignmentHandler", "DataDispatcher", "ClassificationDataHandler",
           "ClusteringDataHandler", "DataHandler", "RecSysDataDispatcher",
           "RecSysDataHandler", "RegressionDataHandler", "get_CIFAR10",
           "get_FEMNIST", "get_FashionMNIST", "load_svmlight",
           "load_classification_dataset", "load_recsys_dataset",
           "standard_scale", "to_device", "SYNTHETIC_DATA_VERSION",
           "UCI_SHAPES", "RECSYS_SHAPES"]

# The UCI datasets the original gossipy downloads: name -> (n_samples,
# n_features, n_classes), the shapes of their synthetic stand-ins.
UCI_SHAPES = {
    "spambase": (4601, 57, 2),
    "sonar": (208, 60, 2),
    "ionosphere": (351, 34, 2),
    "abalone": (4177, 8, 3),
    "banknote": (1372, 4, 2),
    "reuters": (2600, 9947, 2),
}

# Version of the synthetic generator's recipe, the JAX package's
# (2: Bayes-accuracy-calibrated centre separation): a change to the values
# it generates bumps it in both packages.
SYNTHETIC_DATA_VERSION = 2

# The MovieLens sets: name -> (n_users, n_items, n_ratings), the shapes of
# their synthetic stand-ins.
RECSYS_SHAPES = {"ml-100k": (943, 1682, 100_000),
                 "ml-1m": (6040, 3706, 1_000_000),
                 "ml-10m": (69_878, 10_677, 10_000_054),
                 "ml-20m": (138_493, 26_744, 20_000_263)}

# The scikit-learn built-ins of the JAX package's loader (loaded from
# scikit-learn's bundled data where it is installed).
_SKLEARN_BUILTINS = ("iris", "breast", "breast_cancer", "digits", "wine")


def _name_seeded_rng(name: str) -> np.random.Generator:
    """RNG keyed on a dataset name (crc32: Python's string hash is salted
    per process)."""
    return np.random.default_rng(zlib.crc32(name.encode()))


def _synthetic_classification(name: str, n: int, d: int, c: int,
                              seed: Optional[int] = None,
                              bayes_accuracy: float = 0.90):
    """Deterministic synthetic stand-in for a dataset that is not
    downloaded: a Gaussian mixture keyed on the name, its class centres
    scaled so the closest pair's two-class Bayes accuracy
    (``Phi(||mu_i - mu_j|| / 2)``, unit-variance classes) is
    ``bayes_accuracy``. The JAX package's generator, value for value."""
    rng = _name_seeded_rng(name) if seed is None \
        else np.random.default_rng(seed)
    centers = rng.normal(size=(c, d))
    if c > 1:
        diffs = centers[:, None, :] - centers[None, :, :]
        dists = np.sqrt((diffs ** 2).sum(-1))
        np.fill_diagonal(dists, np.inf)
        sep = 2.0 * NormalDist().inv_cdf(bayes_accuracy)
        centers *= sep / dists.min()
    per = n // c
    Xs, ys = [], []
    for k in range(c):
        cnt = per + (1 if k < n % c else 0)
        Xs.append(rng.normal(loc=centers[k], scale=1.0, size=(cnt, d)))
        ys.append(np.full(cnt, k))
    X = np.concatenate(Xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.int64)
    perm = rng.permutation(n)
    return X[perm], y[perm]


def standard_scale(X: np.ndarray) -> np.ndarray:
    """Zero mean and unit population variance per column, as
    scikit-learn's ``StandardScaler().fit_transform``: statistics in
    float64, a constant column (variance within rounding of 0, sklearn's
    ``_is_constant_feature`` bound) keeps scale 1; float32 out."""
    X64 = np.asarray(X, dtype=np.float64)
    n = X64.shape[0]
    mean = X64.mean(axis=0)
    var = X64.var(axis=0)
    eps = np.finfo(np.float64).eps
    constant = var <= n * eps * var + (n * mean * eps) ** 2
    scale = np.where(constant, 1.0, np.sqrt(var))
    return ((X64 - mean) / scale).astype(np.float32)


def load_classification_dataset(name: str = "spambase",
                                normalize: bool = True):
    """A classification dataset as ``(X [n, d] float32, y [n] int64)``.

    The UCI names (:data:`UCI_SHAPES`) give the JAX package's offline
    stand-in, with its warning; no download is tried. A ``name`` that is
    an existing file loads as svmlight (:func:`load_svmlight`), its labels
    encoded to ``0..C-1`` in sorted order, as the JAX package loads one.
    The scikit-learn built-ins (iris, breast / breast_cancer, digits,
    wine) load from the data that ships inside scikit-learn, imported at
    the call (nothing is downloaded); without scikit-learn they raise an
    ``ImportError`` that names it. ``normalize`` applies
    :func:`standard_scale`.
    """
    key = name.lower()
    if key in _SKLEARN_BUILTINS:
        X, y = _load_sklearn_builtin(key)
    elif key in UCI_SHAPES:
        n, d, c = UCI_SHAPES[key]
        warnings.warn(
            f"Dataset '{key}' could not be downloaded (no egress?); using a "
            f"deterministic synthetic stand-in of shape ({n}, {d}).")
        X, y = _synthetic_classification(key, n, d, c)
    elif os.path.isfile(name):
        X, y = load_svmlight(name)
        y = _label_encode(y.tolist())
    else:
        raise ValueError(f"Unknown dataset: {key}")
    X = np.asarray(X, dtype=np.float32)
    y = np.asarray(y, dtype=np.int64)
    if normalize:
        X = standard_scale(X)
    return X, y


def _load_sklearn_builtin(key: str):
    """One of scikit-learn's bundled sets as ``(X, y)``, through a lazy
    ``sklearn.datasets`` import, as the JAX package loads it."""
    loader = {"iris": "load_iris", "breast": "load_breast_cancer",
              "breast_cancer": "load_breast_cancer",
              "digits": "load_digits", "wine": "load_wine"}[key]
    # Imported at the call: the port has no import-time (or hard)
    # dependency on scikit-learn.
    try:
        import sklearn.datasets as sk_datasets
    except ImportError as e:
        raise ImportError(
            f"dataset {key!r} is a scikit-learn built-in and scikit-learn "
            "is not installed; install scikit-learn, or load another "
            "dataset") from e
    return getattr(sk_datasets, loader)(return_X_y=True)


def _label_encode(values) -> np.ndarray:
    """Sorted-unique label encoding (sklearn ``LabelEncoder`` semantics)."""
    classes = {v: i for i, v in enumerate(sorted(set(values)))}
    return np.array([classes[v] for v in values], dtype=np.int64)


def load_svmlight(path: str) -> tuple[np.ndarray, np.ndarray]:
    """An svmlight / libsvm file as dense ``(X [n, d] float64, y [n]
    float64)``, as scikit-learn's ``load_svmlight_file`` reads it with its
    defaults: ``label index:value ...`` lines, ``#`` comments and
    ``qid:`` tokens skipped, the indices of a line sorted and unique (else
    ``ValueError``) and taken as one-based unless some index is 0 (its
    ``zero_based="auto"``); ``d`` is the largest
    index plus one. A numpy reader: the machine with the card has no
    scikit-learn."""
    labels, rows = [], []
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            label, *pairs = line.split()
            labels.append(float(label))
            row = []
            for pair in pairs:
                k, v = pair.split(":", 1)
                if k != "qid":
                    row.append((int(k), float(v)))
            if any(a[0] >= b[0] for a, b in zip(row, row[1:])):
                raise ValueError("Feature indices in SVMlight/LibSVM data "
                                 "file should be sorted and unique.")
            rows.append(row)
    indices = [k for row in rows for k, _ in row]
    shift = 1 if indices and min(indices) > 0 else 0
    d = (max(indices) + 1 - shift) if indices else 0
    X = np.zeros((len(rows), d), dtype=np.float64)
    for i, row in enumerate(rows):
        for k, v in row:
            X[i, k - shift] = v
    return X, np.asarray(labels, dtype=np.float64)


def load_recsys_dataset(name: str = "ml-100k",
                        allow_synthetic: bool = True):
    """MovieLens ratings as ``({user: [(item, rating)]}, n_users,
    n_items)``.

    The port reads no archive and tries no download: it gives the JAX
    package's offline stand-in for ``name`` (:data:`RECSYS_SHAPES`), a
    rank-6 rating matrix keyed on the name, ``n_ratings // n_users``
    distinct items a user, ratings ``clip(round(3 + 1.5 u.v), 1, 5)``,
    value for value, with its warning. ``allow_synthetic=False`` raises.
    """
    if name not in RECSYS_SHAPES:
        raise ValueError(f"Unknown recsys dataset: {name}")
    if not allow_synthetic:
        raise FileNotFoundError(
            f"the real {name} set needs its MovieLens archive, which the "
            "port does not load; pass allow_synthetic=True for the "
            "synthetic stand-in")
    n_users, n_items, n_ratings = RECSYS_SHAPES[name]
    warnings.warn(f"RecSys dataset '{name}' substituted with a synthetic "
                  "low-rank rating matrix (no egress).")
    rng = _name_seeded_rng(name)
    k = 6
    U = rng.normal(size=(n_users, k)) / np.sqrt(k)
    V = rng.normal(size=(n_items, k)) / np.sqrt(k)
    ratings: dict = {}
    per_user = max(n_ratings // n_users, 5)
    for u in range(n_users):
        items = rng.choice(n_items, size=min(per_user, n_items),
                           replace=False)
        raw = U[u] @ V[items].T
        r = np.clip(np.round(3.0 + 1.5 * raw), 1, 5)
        ratings[u] = [(int(i), float(v)) for i, v in zip(items, r)]
    return ratings, n_users, n_items


def _synthetic_images(name: str, n: int, shape: tuple, c: int):
    """Class-dependent Gaussian-blob images, deterministic per name: the
    JAX package's stand-in, value for value."""
    rng = _name_seeded_rng(name)
    y = rng.integers(0, c, size=n).astype(np.int64)
    X = rng.normal(0.0, 1.0, size=(n,) + shape).astype(np.float32)
    h, w = shape[0], shape[1]
    yy, xx = np.mgrid[0:h, 0:w]
    for k in range(c):  # stamp a class-specific blob so the task is learnable
        cy, cx = (k * 7) % h, (k * 11) % w
        blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0)).astype(np.float32)
        X[y == k] += 2.5 * blob[..., None]
    return X, y


def get_CIFAR10(allow_synthetic: bool = True):
    """CIFAR-10 train and test sets as NHWC float32 numpy arrays, ``((X
    [50000, 32, 32, 3], y), (X [10000, 32, 32, 3], y))``.

    The port reads no archive and tries no download: it gives the JAX
    package's offline stand-in (a deterministic synthetic 10-class set of
    CIFAR-10's shapes), with its warning. ``allow_synthetic=False``
    raises, naming the archive the real set comes from.
    """
    if not allow_synthetic:
        raise FileNotFoundError(
            "the real CIFAR-10 set needs cifar-10-python.tar.gz, which the "
            "port does not load; pass allow_synthetic=True for the "
            "synthetic stand-in")
    warnings.warn("CIFAR-10 substituted with synthetic 32x32x3 data (no "
                  "archive is loaded).")
    Xtr, ytr = _synthetic_images("cifar10-train", 50_000, (32, 32, 3), 10)
    Xte, yte = _synthetic_images("cifar10-test", 10_000, (32, 32, 3), 10)
    return (Xtr, ytr), (Xte, yte)


def get_FashionMNIST(allow_synthetic: bool = True):
    """FashionMNIST train and test sets as NHWC float32 numpy arrays,
    ``((X [60000, 28, 28, 1], y), (X [10000, 28, 28, 1], y))``: the JAX
    package's offline stand-in (:func:`_synthetic_images` under the names
    ``fmnist-train`` and ``fmnist-test``), value for value, with its
    warning. No archive is read and no download is tried;
    ``allow_synthetic=False`` raises."""
    if not allow_synthetic:
        raise FileNotFoundError(
            "the real FashionMNIST set needs its idx archives, which the "
            "port does not load; pass allow_synthetic=True for the "
            "synthetic stand-in")
    warnings.warn("FashionMNIST substituted with synthetic 28x28x1 data "
                  "(no egress).")
    Xtr, ytr = _synthetic_images("fmnist-train", 60_000, (28, 28, 1), 10)
    Xte, yte = _synthetic_images("fmnist-test", 10_000, (28, 28, 1), 10)
    return (Xtr, ytr), (Xte, yte)


def get_FEMNIST(n_writers: int = 100, allow_synthetic: bool = True):
    """Federated EMNIST as per-writer shards of 28x28 character images:
    ``((X, y, assignment), (X, y, assignment))`` for the train and test
    splits, ``assignment[i]`` writer ``i``'s row indices. The JAX
    package's offline stand-in, value for value (62 classes, shard sizes
    drawn log-normally from the name-keyed generator, the cursors
    advancing from writer to writer), with its warning. No archive is
    read; ``allow_synthetic=False`` raises."""
    if not allow_synthetic:
        raise FileNotFoundError(
            "the real FEMNIST set needs femnist.tar.gz, which the port "
            "does not load; pass allow_synthetic=True for the synthetic "
            "stand-in")
    warnings.warn("FEMNIST substituted with synthetic per-writer 28x28 data "
                  "(no egress).")
    rng = _name_seeded_rng("femnist")
    n_classes = 62
    sizes_tr = np.maximum((rng.lognormal(4.5, 0.4, n_writers)).astype(int), 8)
    sizes_te = np.maximum(sizes_tr // 5, 2)

    def build(sizes, tag):
        X, y = _synthetic_images(f"femnist-{tag}", int(sizes.sum()),
                                 (28, 28, 1), n_classes)
        assignment, cursor = [], 0
        for size in sizes:
            assignment.append(np.arange(cursor, cursor + int(size)))
            cursor += int(size)
        return X, y, assignment

    return build(sizes_tr, "train"), build(sizes_te, "test")


class AssignmentHandler:
    """Partitioners mapping labels to per-node index arrays; all randomness
    goes through one ``numpy.random.Generator`` seeded at construction.
    Each is the JAX package's, draw for draw: for the same seed they give
    the same index arrays."""

    def __init__(self, seed: int = 42):
        self.rng = np.random.default_rng(seed)

    def uniform(self, y: np.ndarray, n: int) -> list[np.ndarray]:
        """Equal-size random shards."""
        ex_client = y.shape[0] // n
        idx = self.rng.permutation(y.shape[0])
        return [idx[ex_client * i: ex_client * (i + 1)] for i in range(n)]

    def quantity_skew(self, y: np.ndarray, n: int, min_quantity: int = 2,
                      alpha: float = 4.0) -> list[np.ndarray]:
        """Power-law shard sizes, ``min_quantity`` rows guaranteed."""
        if min_quantity * n > y.shape[0]:
            raise ValueError("# of instances must be > than min_quantity*n")
        if min_quantity <= 0:
            raise ValueError("min_quantity must be >= 1")
        s = (self.rng.power(alpha, y.shape[0] - min_quantity * n) * n).astype(int)
        m = np.repeat(np.arange(n), min_quantity)
        assignment = np.concatenate([s, m])
        self.rng.shuffle(assignment)
        return [np.where(assignment == i)[0] for i in range(n)]

    def classwise_quantity_skew(self, y: np.ndarray, n: int, min_quantity: int = 2,
                                alpha: float = 4.0) -> list[np.ndarray]:
        """Per-class power-law splits."""
        if min_quantity * n > y.shape[0]:
            raise ValueError("# of instances must be > than min_quantity*n")
        if min_quantity <= 0:
            raise ValueError("min_quantity must be >= 1")
        labels = np.unique(y)
        lens = [int((y == c).sum()) for c in labels]
        if min(lens) < n:
            raise ValueError("Under represented class!")
        res: list[list[int]] = [[] for _ in range(n)]
        for c, ln in zip(labels, lens):
            s = (self.rng.power(alpha, ln - n) * n).astype(int)
            ass = np.concatenate([s, np.arange(n)])
            self.rng.shuffle(ass)
            idc = np.where(y == c)[0]
            for i in range(n):
                res[i].extend(idc[np.where(ass == i)[0]])
        return [np.array(sorted(r), dtype=int) for r in res]

    def label_quantity_skew(self, y: np.ndarray, n: int,
                            class_per_client: int = 2) -> list[np.ndarray]:
        """k-classes-per-client split (Li et al. 2021)."""
        labels = set(np.unique(y).tolist())
        if not 0 < class_per_client <= len(labels):
            raise ValueError("class_per_client must be > 0 and <= #classes")
        if class_per_client * n < len(labels):
            raise ValueError("class_per_client * n must be >= #classes")
        nlbl = [self.rng.choice(len(labels), class_per_client, replace=False)
                for _ in range(n)]
        covered = set().union(*[set(a.tolist()) for a in nlbl])
        while len(covered) < len(labels):
            for missing in labels - covered:
                nlbl[self.rng.integers(0, n)][self.rng.integers(0, class_per_client)] = missing
            covered = set().union(*[set(a.tolist()) for a in nlbl])
        class_map = {c: [u for u, lbl in enumerate(nlbl) if c in lbl] for c in labels}
        assignment = np.zeros(y.shape[0], dtype=int)
        for lbl, users in class_map.items():
            ids = np.where(y == lbl)[0]
            assignment[ids] = self.rng.choice(users, len(ids))
        return [np.where(assignment == i)[0] for i in range(n)]

    def label_dirichlet_skew(self, y: np.ndarray, n: int,
                             beta: float = 0.1) -> list[np.ndarray]:
        """Dirichlet(beta) class allocation; each client gets at least one
        example of each class (the ``ids[:n]`` seeding)."""
        if beta <= 0:
            raise ValueError("beta must be > 0")
        labels = np.unique(y)
        assignment = np.zeros(y.shape[0], dtype=int)
        for c in labels:
            pk = self.rng.dirichlet([beta] * n)
            ids = np.where(y == c)[0]
            self.rng.shuffle(ids)
            assignment[ids[n:]] = self.rng.choice(n, size=max(len(ids) - n, 0), p=pk)
            assignment[ids[:n]] = np.arange(min(n, len(ids)))
        return [np.where(assignment == i)[0] for i in range(n)]

    def label_pathological_skew(self, y: np.ndarray, n: int,
                                shards_per_client: int = 2) -> list[np.ndarray]:
        """Sorted-shard split (McMahan 2017)."""
        sorted_ids = np.argsort(y, kind="stable")
        n_shards = int(shards_per_client * n)
        shard_size = int(np.ceil(len(y) / n_shards))
        assignment = np.zeros(y.shape[0], dtype=int)
        perm = self.rng.permutation(n_shards)
        j = 0
        for i in range(n):
            for _ in range(shards_per_client):
                left = perm[j] * shard_size
                right = min((perm[j] + 1) * shard_size, len(y))
                assignment[sorted_ids[left:right]] = i
                j += 1
        return [np.where(assignment == i)[0] for i in range(n)]


class DataDispatcher:
    """Assigns data shards to nodes and emits stacked padded arrays."""

    def __init__(self, data_handler, n: int = 0, eval_on_user: bool = True,
                 auto_assign: bool = True,
                 assignment: Optional[Callable] = None,
                 **assignment_kwargs):
        if data_handler.size() < n:
            raise ValueError("Not enough data to dispatch")
        self.data_handler = data_handler
        self.n = n if n > 0 else data_handler.size()
        self.eval_on_user = eval_on_user
        self.tr_assignments: Optional[list[np.ndarray]] = None
        self.te_assignments: Optional[list[np.ndarray]] = None
        self._assignment_fn = assignment
        self._assignment_kwargs = assignment_kwargs
        if auto_assign:
            self.assign()

    def assign(self, seed: int = 42) -> None:
        """Split train (and optionally eval) indices across the n nodes."""
        handler = AssignmentHandler(seed)
        fn = self._assignment_fn or AssignmentHandler.uniform
        _, ytr = self.data_handler.get_train_set()
        self.tr_assignments = fn(handler, np.asarray(ytr), self.n,
                                 **self._assignment_kwargs)
        if self.eval_on_user and self.data_handler.eval_size() > 0:
            ev = self.data_handler.get_eval_set()
            self.te_assignments = AssignmentHandler(seed).uniform(
                np.asarray(ev[1]), self.n)
        else:
            self.te_assignments = [np.array([], dtype=int)
                                   for _ in range(self.n)]

    def set_assignments(self, tr: list[np.ndarray],
                        te: Optional[list[np.ndarray]] = None) -> None:
        """Custom splits: ``tr`` (and ``te``, else empty) per node."""
        if len(tr) != self.n:
            raise ValueError(f"{len(tr)} train splits for {self.n} nodes")
        self.tr_assignments = [np.asarray(a, dtype=int) for a in tr]
        if te is not None:
            self.te_assignments = [np.asarray(a, dtype=int) for a in te]
        else:
            self.te_assignments = [np.array([], dtype=int)
                                   for _ in range(self.n)]

    def __getitem__(self, idx: int):
        """Node idx's (train, test) shards."""
        if not 0 <= idx < self.n:
            raise IndexError(f"Index {idx} out of range [0, {self.n})")
        return (self.data_handler.at(self.tr_assignments[idx]),
                self.data_handler.at(self.te_assignments[idx], eval_set=True))

    def size(self) -> int:
        return self.n

    def get_eval_set(self):
        return self.data_handler.get_eval_set()

    def has_test(self) -> bool:
        return self.data_handler.eval_size() > 0

    @staticmethod
    def _pad_stack(arrs: list[np.ndarray], pad_to: Optional[int] = None):
        """Stack variable-length arrays into [N, S, ...] + mask [N, S]."""
        s_max = max((a.shape[0] for a in arrs), default=0)
        if pad_to is not None:
            s_max = max(s_max, pad_to)
        s_max = max(s_max, 1)
        n = len(arrs)
        out = np.zeros((n, s_max) + arrs[0].shape[1:], dtype=arrs[0].dtype)
        mask = np.zeros((n, s_max), dtype=np.float32)
        for i, a in enumerate(arrs):
            out[i, : a.shape[0]] = a
            mask[i, : a.shape[0]] = 1.0
        return out, mask

    def stacked(self, pad_to: Optional[int] = None) -> dict:
        """Stacked padded shards for the whole network, as numpy arrays:
        ``xtr [N,S,...], ytr [N,S], mtr [N,S]`` and, when eval data exists,
        ``xte/yte/mte`` (per node, with ``eval_on_user``) and
        ``x_eval/y_eval`` (the global eval set)."""
        if self.tr_assignments is None:
            raise RuntimeError("call assign() first")
        Xtr, ytr = self.data_handler.get_train_set()
        Xtr, ytr = np.asarray(Xtr), np.asarray(ytr)
        xs = [Xtr[a] for a in self.tr_assignments]
        ys = [ytr[a] for a in self.tr_assignments]
        x_stack, mask = self._pad_stack(xs, pad_to)
        y_stack, _ = self._pad_stack(ys, x_stack.shape[1])
        out = {"xtr": x_stack, "ytr": y_stack, "mtr": mask}
        if self.has_test():
            Xte, yte = self.data_handler.get_eval_set()
            Xte, yte = np.asarray(Xte), np.asarray(yte)
            if self.eval_on_user:
                xs = [Xte[a] for a in self.te_assignments]
                ys = [yte[a] for a in self.te_assignments]
                x_stack, mask = self._pad_stack(xs)
                y_stack, _ = self._pad_stack(ys, x_stack.shape[1])
                out.update({"xte": x_stack, "yte": y_stack, "mte": mask})
            out.update({"x_eval": Xte, "y_eval": yte})
        return out

    def __str__(self) -> str:
        return (f"DataDispatcher(handler={self.data_handler.__class__.__name__}, "
                f"n={self.n}, eval_on_user={self.eval_on_user})")


class RecSysDataDispatcher(DataDispatcher):
    """One user a node, in a seeded permutation of the users; each node's
    train and test ratings stacked as ``items [N, S]`` (int32),
    ``ratings [N, S]`` (float32) and ``mask [N, S]``."""

    def __init__(self, data_handler: RecSysDataHandler):
        self.data_handler = data_handler
        self.n = data_handler.size()
        self.eval_on_user = True
        self.assign()

    def assign(self, seed: int = 42) -> None:
        rng = np.random.default_rng(seed)
        self.assignments = rng.permutation(self.n)

    def __getitem__(self, idx: int):
        u = int(self.assignments[idx])
        return (self.data_handler.at(u),
                self.data_handler.at(u, eval_set=True))

    def has_test(self) -> bool:
        return True

    def get_eval_set(self):
        return None

    def stacked(self, pad_to: Optional[int] = None) -> dict:
        """``xtr/ytr/mtr`` (train) and ``xte/yte/mte`` (test): items,
        ratings and mask of every node's ratings, padded to one length."""
        def pack(eval_set: bool):
            items, rates = [], []
            for i in range(self.n):
                r = self.data_handler.at(int(self.assignments[i]),
                                         eval_set=eval_set)
                items.append(np.array([it for it, _ in r], dtype=np.int32))
                rates.append(np.array([v for _, v in r], dtype=np.float32))
            it_stack, mask = self._pad_stack(items, pad_to)
            rt_stack, _ = self._pad_stack(rates, pad_to)
            return it_stack, rt_stack, mask

        itr, rtr, mtr = pack(False)
        ite, rte, mte = pack(True)
        return {"xtr": itr, "ytr": rtr, "mtr": mtr,
                "xte": ite, "yte": rte, "mte": mte}


def to_device(stacked: dict, device=None) -> dict:
    """Move a :meth:`DataDispatcher.stacked` dict onto ``device`` (``cuda``
    unless ``device="cpu"``): floating arrays (features, masks, float
    labels such as ±1 targets, ratings or regression targets) as float32,
    integer labels as int64, other integer arrays (item ids) as they
    are. A label keeps its kind, as in the JAX engine."""
    dev = resolve_device(device)
    out = {}
    for k, v in stacked.items():
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        if t.is_floating_point():
            t = t.to(torch.float32)
        elif k.startswith("y"):
            t = t.to(torch.int64)
        out[k] = t.to(dev)
    return out
