"""Data handlers: typed train/eval containers with seeded splits.

A numpy copy of ``gossipy_tpu/data/handler.py`` (it runs once at set-up,
on the host): classification, clustering (the eval set is the training
set), regression (float labels) and per-user rating lists. The splits
must stay array-equal to the JAX package's, which
``tests/test_torch_isolation.py`` and ``tests/test_torch_papers.py``
hold.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class DataHandler:
    """Abstract base."""

    def size(self, dim: int = 0) -> int:
        raise NotImplementedError

    def get_train_set(self):
        raise NotImplementedError

    def get_eval_set(self):
        raise NotImplementedError

    def eval_size(self) -> int:
        raise NotImplementedError


class ClassificationDataHandler(DataHandler):
    """Classification data with a seeded train/eval split: ``test_size``
    of the rows, chosen by ``default_rng(seed).permutation``, form the
    eval set."""

    def __init__(self,
                 X: np.ndarray,
                 y: np.ndarray,
                 X_te: Optional[np.ndarray] = None,
                 y_te: Optional[np.ndarray] = None,
                 test_size: float = 0.2,
                 seed: int = 42):
        if not 0 <= test_size < 1:
            raise ValueError("test_size must be in [0, 1)")
        X = np.asarray(X)
        y = np.asarray(y)
        if X_te is not None:
            if y_te is None:
                raise ValueError("y_te must be provided along with X_te")
            self.Xtr, self.ytr = X, y
            self.Xte, self.yte = np.asarray(X_te), np.asarray(y_te)
        elif test_size > 0:
            rng = np.random.default_rng(seed)
            perm = rng.permutation(X.shape[0])
            n_te = int(X.shape[0] * test_size)
            te, tr = perm[:n_te], perm[n_te:]
            self.Xtr, self.ytr = X[tr], y[tr]
            self.Xte, self.yte = X[te], y[te]
        else:
            self.Xtr, self.ytr = X, y
            self.Xte, self.yte = None, None
        self.n_classes = int(len(np.unique(y)))

    def __getitem__(self, idx):
        return self.at(idx)

    def at(self, idx, eval_set: bool = False):
        if eval_set:
            if self.Xte is None or (hasattr(idx, "__len__") and len(idx) == 0):
                return None
            return self.Xte[idx], self.yte[idx]
        return self.Xtr[idx], self.ytr[idx]

    def size(self, dim: int = 0) -> int:
        return self.Xtr.shape[dim]

    def get_train_set(self):
        return self.Xtr, self.ytr

    def get_eval_set(self):
        return (self.Xte, self.yte) if self.Xte is not None else None

    def eval_size(self) -> int:
        return 0 if self.Xte is None else self.Xte.shape[0]


class ClusteringDataHandler(ClassificationDataHandler):
    """Unsupervised: the evaluation set is the training set."""

    def __init__(self, X: np.ndarray, y: np.ndarray):
        super().__init__(X, y, test_size=0)
        self.Xte, self.yte = self.Xtr, self.ytr

    def get_eval_set(self):
        return self.Xtr, self.ytr

    def eval_size(self) -> int:
        return self.size()


class RegressionDataHandler(ClassificationDataHandler):
    """Float labels: ``at`` returns them as float32."""

    def at(self, idx, eval_set: bool = False):
        out = super().at(idx, eval_set)
        if out is None:
            return None
        X, y = out
        return X, y.astype(np.float32)


class RecSysDataHandler(DataHandler):
    """Per-user rating lists with a positional train/test split: each
    user's ``(item, rating)`` list (``ratings[u]``) is permuted with one
    seeded generator, in user order, and its first ``round(len * (1 -
    test_size))`` entries train."""

    def __init__(self, ratings: dict, n_users: int, n_items: int,
                 test_size: float = 0.2, seed: int = 42):
        self.n_users = n_users
        self.n_items = n_items
        rng = np.random.default_rng(seed)
        self.ratings = {}
        self._test_offset = {}
        for u in range(n_users):
            r = list(ratings.get(u, []))
            perm = rng.permutation(len(r))
            r = [r[i] for i in perm]
            self.ratings[u] = r
            self._test_offset[u] = max(int(round(len(r) * (1 - test_size))),
                                       0)

    def __getitem__(self, u: int):
        return self.ratings[u][: self._test_offset[u]]

    def at(self, u: int, eval_set: bool = False):
        if eval_set:
            return self.ratings[u][self._test_offset[u]:]
        return self.ratings[u][: self._test_offset[u]]

    def size(self, dim: int = 0) -> int:
        return self.n_users

    def get_train_set(self):
        return self.ratings

    def get_eval_set(self):
        return None

    def eval_size(self) -> int:
        return 0
