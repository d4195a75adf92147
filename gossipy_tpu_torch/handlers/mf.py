"""Gossip matrix factorisation, one user a node (Hegedus 2020).

Counterpart of ``gossipy_tpu/handlers/mf.py``. A node's params are the
user factor ``X [k]``, the user bias ``b`` (a scalar leaf), the item
factors ``Y [n_items, k]`` and the item biases ``c [n_items]``, flattened
in the JAX pytree's leaf order (sorted keys: ``X``, ``Y``, ``b``, ``c``).
Data is ``(items [N, S] int, ratings [N, S] float, mask [N, S])``.

The JAX handler scans one node's ratings; here the loop runs over the S
rating slots and each step gathers every row's ``Y[i]`` and ``c[i]``,
updates them and scatters them back. Only the item state (``Y``, ``c``)
is merged, age-weighted, and only it travels (:meth:`MFHandler.get_size`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import resolve_device
from ..core import CreateModelMode
from ..models.nn import ParamLayout
from ..utils import rmse
from .base import BaseHandler, ModelState, PeerModel


class MFHandler(BaseHandler):
    """SGD on each node's ratings with L2 decay ``lam_reg`` and step
    ``learning_rate``; the age starts at 1 and counts the ratings seen."""

    def __init__(self, dim: int, n_items: int, lam_reg: float = 0.1,
                 learning_rate: float = 0.001,
                 r_min: float = 1.0, r_max: float = 5.0,
                 create_model_mode: CreateModelMode = CreateModelMode.UPDATE):
        self.k = dim
        self.n_items = n_items
        self.reg = lam_reg
        self.lr = learning_rate
        self.r_min = r_min
        self.r_max = r_max
        self.mode = create_model_mode
        self.layout = ParamLayout([("X", (dim,)), ("Y", (n_items, dim)),
                                   ("b", ()), ("c", (n_items,))])

    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> ModelState:
        """Factors ``U(0, 1) * sqrt((r_max - r_min) / k)``, biases
        ``r_min / 2``, age 1."""
        dev = resolve_device(device)
        g = generator if generator is not None else torch.Generator()
        mul = math.sqrt((self.r_max - self.r_min) / self.k)
        leaves = {
            "X": torch.rand((self.k,), generator=g) * mul,
            "b": torch.tensor(self.r_min / 2.0),
            "Y": torch.rand((self.n_items, self.k), generator=g) * mul,
            "c": torch.ones(self.n_items) * (self.r_min / 2.0),
        }
        return ModelState(self.layout.flatten(leaves).to(dev), (),
                          torch.ones((), dtype=torch.int32, device=dev))

    def update(self, state: ModelState, data, perms=None) -> ModelState:
        """One SGD step per rating slot, in order (``Y[i]`` first, then
        ``X`` with the updated ``Y[i]``); a masked slot changes nothing.
        Draws nothing."""
        items, ratings, mask = data
        lr, reg = self.lr, self.reg
        params = state.params.clone()
        v = self.layout.views(params)
        X, Y, b, c = v["X"], v["Y"], v["b"], v["c"]
        n = state.n_updates
        rows = torch.arange(params.shape[0], device=params.device)
        for s in range(mask.shape[1]):
            i = items[:, s].long()
            r = ratings[:, s]
            live = mask[:, s] > 0
            yi = Y[rows, i]
            ci = c[rows, i]
            err = r - (X * yi).sum(dim=-1) - b - ci
            yi_new = (1.0 - reg * lr) * yi + (lr * err)[:, None] * X
            x_new = (1.0 - reg * lr) * X + (lr * err)[:, None] * yi_new
            Y[rows, i] = torch.where(live[:, None], yi_new, yi)
            c[rows, i] = torch.where(live, ci + lr * err, ci)
            X.copy_(torch.where(live[:, None], x_new, X))
            b.copy_(torch.where(live, b + lr * err, b))
            n = n + live.to(n.dtype)
        return ModelState(params, (), n)

    def _item_spans(self):
        """Column spans of ``Y`` and ``c`` in the flat row."""
        o = self.layout.offsets
        return ((o["Y"], o["Y"] + self.n_items * self.k),
                (o["c"], o["c"] + self.n_items))

    def merge(self, state: ModelState, peer: PeerModel) -> ModelState:
        """``Y`` and ``c`` become the age-weighted average ``(own n1 +
        peer n2) / max(n1 + n2, 1)``; ``X``, ``b`` and the age stay the
        receiver's."""
        n1 = state.n_updates.to(torch.float32)[..., None]
        n2 = peer.n_updates.to(torch.float32)[..., None]
        den = torch.clamp(n1 + n2, min=1.0)
        params = state.params.clone()
        for lo, hi in self._item_spans():
            params[..., lo:hi] = (state.params[..., lo:hi] * n1
                                  + peer.params[..., lo:hi] * n2) / den
        return ModelState(params, (), state.n_updates)

    @torch.no_grad()
    def evaluate(self, state: ModelState, data) -> dict:
        """The RMSE of the predictions ``Y[i] . X + b + c[i]`` over the
        node's rated items, one value per node."""
        items, ratings, mask = data
        v = self.layout.views(state.params)
        idx = items.long()
        rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
        dot = (v["Y"][rows, idx] * v["X"][:, None, :]).sum(dim=-1)
        pred = dot + v["b"][:, None] + v["c"][rows, idx]
        return {"rmse": rmse(pred, ratings, mask)}

    def get_size(self) -> int:
        """Scalars a message carries: only ``Y`` and ``c`` travel."""
        return self.k * (self.n_items + 1)
