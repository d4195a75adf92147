"""The SGD-trained model handler over a stacked population.

Counterpart of ``gossipy_tpu/handlers/sgd.py::SGDHandler`` with plain SGD
(``p -= lr * g``, the JAX package's ``optax.sgd`` without momentum). The
JAX handler is written for one node and vmapped by the engine; this one
takes every node at once: ``params [N, stride]``, data ``[N, S, ...]`` and
shard orders ``[N, epochs, S]`` from the draw provider.

Each node's loss depends on its own row only, so one backward pass of the
SUM of the per-node losses yields every node's own gradient, as a flat
``[N, stride]`` tensor that the step subtracts in place of a per-leaf
optimizer.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from .. import resolve_device
from ..core import CreateModelMode
from ..models.nn import ParamLayout, init_flat
from ..utils import classification_metrics
from .base import ModelState


class SGDHandler:
    """Train/merge/eval for a stacked model under plain SGD.

    - ``update``: ``local_epochs`` passes of permuted minibatch SGD over
      each node's padded shard; a batch with no real row is a no-op and
      does not count in ``n_updates``.
    - merge: the uniform parameter average (``merge_peer_weight = 0.5``),
      age = max; the engine applies it through the gather-merge kernel.
    - ``evaluate``: accuracy and macro precision/recall/F1 (plus AUC for
      two classes), one value per node.
    """

    uniform_avg_merge = True
    merge_peer_weight = 0.5

    def __init__(self,
                 model,
                 loss: Callable,
                 learning_rate: float = 0.01,
                 local_epochs: int = 1,
                 batch_size: int = 32,
                 n_classes: int = 2,
                 input_shape: Sequence[int] = (2,),
                 create_model_mode: CreateModelMode = CreateModelMode.MERGE_UPDATE,
                 compute_dtype=None):
        if compute_dtype is not None:
            raise NotImplementedError(
                "compute_dtype is not ported yet: the port computes in fp32")
        if local_epochs < 1 or batch_size < 1:
            raise NotImplementedError(
                "the port runs local_epochs >= 1 with batch_size >= 1")
        self.model = model
        self.loss = loss
        self.learning_rate = float(learning_rate)
        self.local_epochs = int(local_epochs)
        self.batch_size = int(batch_size)
        self.n_classes = n_classes
        self.input_shape = tuple(input_shape)
        self.mode = create_model_mode
        self.layout = ParamLayout(model.leaves)

    def get_size(self) -> int:
        """Scalars per node (message-size accounting)."""
        return self.layout.width

    def apply(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Forward of every node: ``params [N, stride]``, ``x [N, B, ...]``."""
        return self.model.forward(self.layout.views(params), x)

    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> ModelState:
        """One node's initial state (flat ``[stride]`` params, age 0) on
        ``device`` (``cuda`` unless ``device="cpu"``)."""
        dev = resolve_device(device)
        return ModelState(init_flat(self.model, self.layout, generator).to(dev),
                          torch.zeros((), dtype=torch.int32, device=dev))

    # -- training ----------------------------------------------------------

    def _sgd_step(self, params, n_updates, xb, yb, mb):
        p = params.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = self.loss(self.apply(p, xb), yb, mb).sum()
            (grad,) = torch.autograd.grad(loss, p)
        any_real = mb.sum(dim=1) > 0
        stepped = params - self.learning_rate * grad
        params = torch.where(any_real[:, None], stepped, params)
        return params, n_updates + any_real.to(n_updates.dtype)

    def update(self, state: ModelState, data, perms: torch.Tensor
               ) -> ModelState:
        """Local training of every node.

        ``data = (X [N, S, ...], y [N, S], mask [N, S])``; ``perms``
        ``[N, local_epochs, S]`` gives each node's shard order per epoch.
        When ``S`` is not a multiple of the batch size the order wraps and
        the wrapped tail is masked out, as in the JAX handler.
        """
        X, y, mask = data
        n, s = mask.shape
        B = self.batch_size
        n_batches = max(1, math.ceil(s / B))
        slots = torch.arange(n_batches * B, device=mask.device)
        wrap = slots % s
        slot_ok = (slots < s).to(mask.dtype)
        rows = torch.arange(n, device=mask.device)[:, None]
        params, n_updates = state.params, state.n_updates
        for e in range(self.local_epochs):
            order = perms[:, e, wrap]
            for i in range(n_batches):
                idx = order[:, i * B:(i + 1) * B]
                mb = mask[rows, idx] * slot_ok[i * B:(i + 1) * B]
                params, n_updates = self._sgd_step(
                    params, n_updates, X[rows, idx], y[rows, idx], mb)
        return ModelState(params, n_updates)

    # -- evaluation --------------------------------------------------------

    @torch.no_grad()
    def evaluate(self, state: ModelState, data) -> dict:
        """Metrics per node: ``{name: [N]}``."""
        X, y, mask = data
        scores = self.apply(state.params, X)
        return classification_metrics(scores, y, self.n_classes, mask)
