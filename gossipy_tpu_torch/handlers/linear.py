"""AdaLine and Pegasos handlers: linear learners trained by hand-written
per-sample rules, no autograd.

Counterpart of ``gossipy_tpu/handlers/linear.py``. The JAX handler runs
one node's samples through a ``lax.scan`` and is vmapped over the nodes;
here the loop runs over the S sample slots and each step updates all N
rows at once. A masked (padding) sample leaves both ``w`` and the age as
they are. Labels are ±1 floats.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..core import CreateModelMode
from ..models.nn import AdaLine, ParamLayout
from ..utils import signed_binary_metrics
from .base import BaseHandler, ModelState, PeerModel


class AdaLineHandler(BaseHandler):
    """Delta-rule learner: per sample ``w += lr * (y_i - w.x_i) * x_i``;
    ``n_updates`` counts the samples seen. ``merge`` is the uniform
    average with age = max, so the fused kernels may replace it."""

    uniform_avg_merge = True
    merge_peer_weight = 0.5

    def __init__(self, net: AdaLine, learning_rate: float,
                 create_model_mode: CreateModelMode = CreateModelMode.UPDATE):
        self.net = net
        self.learning_rate = learning_rate
        self.mode = create_model_mode
        self.layout = ParamLayout(net.leaves)

    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> ModelState:
        """The zero vector (as a flat ``[stride]`` row), age 0."""
        dev = resolve_device(device)
        params = self.layout.flatten(self.net.init(generator)).to(dev)
        return ModelState(params, (),
                          torch.zeros((), dtype=torch.int32, device=dev))

    def _step(self, w, n, x_i, y_i):
        lr = self.learning_rate
        score = (w * x_i).sum(dim=-1)
        return w + (lr * (y_i - score))[:, None] * x_i, n + 1

    def _scan_samples(self, state: ModelState, data) -> ModelState:
        """The rule of :meth:`_step` over the S sample slots in order,
        every row at once; a masked slot changes nothing."""
        X, y, mask = data
        dim = self.net.dim
        w = state.params[:, :dim]
        n = state.n_updates
        for i in range(mask.shape[1]):
            w_new, n_new = self._step(w, n, X[:, i], y[:, i])
            live = mask[:, i] > 0
            w = torch.where(live[:, None], w_new, w)
            n = torch.where(live, n_new, n)
        params = F.pad(w, (0, self.layout.stride - dim))
        return ModelState(params, (), n)

    def update(self, state: ModelState, data, perms=None) -> ModelState:
        """Local pass over every node's samples (``data = (X [N, S, dim],
        y [N, S] ±1, mask [N, S])``); draws nothing."""
        return self._scan_samples(state, data)

    def merge(self, state: ModelState, peer: PeerModel) -> ModelState:
        """``0.5 * (own + peer)``, age = max (the JAX expression, so it
        rounds the same)."""
        return ModelState(0.5 * (state.params + peer.params), (),
                          torch.maximum(state.n_updates, peer.n_updates))

    @torch.no_grad()
    def evaluate(self, state: ModelState, data) -> dict:
        """:func:`signed_binary_metrics` of the scores ``X @ w``, one value
        per node."""
        X, y, mask = data
        scores = self.net.forward(self.layout.views(state.params), X)
        return signed_binary_metrics(scores, y, mask)


class PegasosHandler(AdaLineHandler):
    """Pegasos SVM; ``learning_rate`` is the regularisation constant
    lambda. Per sample, with ``t`` the age plus one and ``eta = 1 / (t
    lambda)`` in float32: ``w <- (1 - eta lambda) w + [y_i (w_old . x_i)
    < 1] eta y_i x_i``, the margin taken on the weights before the
    decay."""

    def _step(self, w, n, x_i, y_i):
        lam = self.learning_rate
        t = (n + 1).to(torch.float32)
        eta = 1.0 / (t * lam)
        score = (w * x_i).sum(dim=-1)
        w = w * (1.0 - eta * lam)[:, None]
        hinge_active = (score * y_i - 1.0) < 0
        step = torch.where(hinge_active, eta * y_i, torch.zeros_like(eta))
        return w + step[:, None] * x_i, n + 1
