"""Data layer: uniform assignment, the shard dispatcher, and the step that
puts the stacked shards on the device.

A numpy copy of the parts of ``gossipy_tpu/data/__init__.py`` the ported
path runs (assignment and stacking run once at set-up, on the host).
:meth:`DataDispatcher.stacked` pads every node's shard to one length and
returns ``X [N, S, ...]``, ``y [N, S]`` and ``mask [N, S]`` (1.0 on real
rows); :func:`to_device` moves that dict onto the run's device.

The non-uniform partitioners and the dataset loaders are still to be
ported.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from .handler import ClassificationDataHandler, DataHandler

__all__ = ["AssignmentHandler", "DataDispatcher", "ClassificationDataHandler",
           "DataHandler", "to_device"]


class AssignmentHandler:
    """Partitioners mapping labels to per-node index arrays; all randomness
    goes through one ``numpy.random.Generator`` seeded at construction."""

    def __init__(self, seed: int = 42):
        self.rng = np.random.default_rng(seed)

    def uniform(self, y: np.ndarray, n: int) -> list[np.ndarray]:
        """Equal-size random shards."""
        ex_client = y.shape[0] // n
        idx = self.rng.permutation(y.shape[0])
        return [idx[ex_client * i: ex_client * (i + 1)] for i in range(n)]


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


def to_device(stacked: dict, device=None) -> dict:
    """Move a :meth:`DataDispatcher.stacked` dict onto ``device`` (``cuda``
    unless ``device="cpu"``): features and masks as float32, labels as
    int64."""
    dev = resolve_device(device)
    out = {}
    for k, v in stacked.items():
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        if k.startswith("y"):
            t = t.to(torch.int64)
        elif t.is_floating_point():
            t = t.to(torch.float32)
        out[k] = t.to(dev)
    return out
