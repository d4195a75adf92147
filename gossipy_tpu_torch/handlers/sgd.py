"""The SGD-trained model handler over a stacked population.

Counterpart of ``gossipy_tpu/handlers/sgd.py::SGDHandler``: local training
under an optimizer of :mod:`gossipy_tpu_torch.optim` (optax's rules; plain
``sgd(learning_rate)`` by default). The JAX handler is written for one
node and vmapped by the engine; this one takes every node at once:
``params [N, stride]``, its optimizer state with a leading node axis, data
``[N, S, ...]`` and shard orders ``[N, epochs, S]`` from the draw
provider.

Each node's loss depends on its own row only, so one backward pass of the
SUM of the per-node losses yields every node's own gradient, as a flat
``[N, stride]`` tensor that the optimizer turns into the step.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..compression import ModelPartition, sampled_merge
from ..core import CreateModelMode
from ..models.nn import ParamLayout, init_flat, init_rows
from ..optim import Optimizer, apply_updates, sgd
from ..utils import classification_metrics
from .base import BaseHandler, ModelState, PeerModel, select_state


class SGDHandler(BaseHandler):
    """Train/merge/eval for a stacked model under an optimizer.

    - ``update``: ``local_epochs`` passes of permuted minibatch steps over
      each node's padded shard (``batch_size=0``: the whole shard is one
      batch; ``local_epochs=0``: one step on ``batch_size`` random rows);
      a batch with no real row is a no-op for the params and the optimizer
      state and does not count in ``n_updates``.
    - ``merge``: the uniform parameter average, age = max, the receiver's
      optimizer state (``merge_peer_weight = 0.5``); the engine's plain
      deliver applies it through ``call``, its fused deliver through the
      gather-merge kernels.
    - ``evaluate``: accuracy and macro precision/recall/F1 (plus AUC for
      two classes), one value per node.

    ``compute_dtype`` (``torch.bfloat16``) casts params and inputs for the
    forward and backward passes and returns the scores as float32; the
    master params, the optimizer state and the merges stay float32.
    ``remat`` recomputes the forward during the backward pass
    (``torch.utils.checkpoint``) instead of keeping its activations.
    """

    uniform_avg_merge = True
    merge_peer_weight = 0.5

    def __init__(self,
                 model,
                 loss: Callable,
                 optimizer: Optional[Optimizer] = None,
                 learning_rate: float = 0.01,
                 local_epochs: int = 1,
                 batch_size: int = 32,
                 n_classes: int = 2,
                 input_shape: Sequence[int] = (2,),
                 create_model_mode: CreateModelMode = CreateModelMode.MERGE_UPDATE,
                 compute_dtype: Optional[torch.dtype] = None,
                 remat: bool = False):
        if local_epochs < 0 or batch_size < 0 or \
                (batch_size == 0 and local_epochs == 0):
            raise ValueError("batch_size == 0 (full batch) requires "
                             "local_epochs > 0; neither may be negative")
        self.model = model
        self.loss = loss
        self.optimizer = optimizer if optimizer is not None \
            else sgd(learning_rate)
        self.local_epochs = int(local_epochs)
        self.batch_size = int(batch_size)
        self.n_classes = n_classes
        self.input_shape = tuple(input_shape)
        self.mode = create_model_mode
        self.compute_dtype = compute_dtype
        self.remat = bool(remat)
        self.layout = ParamLayout(model.leaves)

    def init_opt_state(self, params: torch.Tensor) -> tuple:
        """The optimizer's initial state of rows ``params``."""
        return self.optimizer.init(params)

    def orders_per_update(self) -> int:
        """One shard order per local epoch (``local_epochs=0``: the one
        order of a single step)."""
        return self.local_epochs

    def apply(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Forward of every node: ``params [N, stride]``, ``x [N, B, ...]``;
        float32 scores."""
        if self.compute_dtype is not None:
            views = self.layout.views(params.to(self.compute_dtype))
            return self.model.forward(views, x.to(self.compute_dtype)).to(
                torch.float32)
        return self.model.forward(self.layout.views(params), x)

    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> ModelState:
        """One node's initial state (flat ``[stride]`` params, the
        optimizer's initial state, age 0) on ``device`` (``cuda`` unless
        ``device="cpu"``)."""
        dev = resolve_device(device)
        params = init_flat(self.model, self.layout, generator).to(dev)
        return ModelState(params, self.optimizer.init(params),
                          torch.zeros((), dtype=torch.int32, device=dev))

    def init_rows(self, b: int, draw) -> Optional[ModelState]:
        """``b`` nodes' :meth:`init` at once on the host (the model's
        draws as columns of ``draw``'s uniforms; None when its draws mix
        dtypes)."""
        params = init_rows(self.model, self.layout, b, draw)
        if params is None:
            return None
        age = self.init(torch.Generator(), "cpu").n_updates
        return ModelState(params, self.init_opt_state(params),
                          age.expand(b, *age.shape).clone())

    # -- training ----------------------------------------------------------

    def _adjust_gradient(self, grad: torch.Tensor,
                         n_updates: torch.Tensor) -> torch.Tensor:
        """Hook on the flat ``[N, stride]`` gradient before the optimizer
        (:class:`PartitionedSGDHandler` divides by the part's age)."""
        return grad

    def _count_updates(self, n_updates: torch.Tensor,
                       any_real: torch.Tensor) -> torch.Tensor:
        """The ages after a step; ``any_real`` is ``[N]``."""
        return n_updates + any_real.to(n_updates.dtype)

    def _sgd_step(self, state: ModelState, xb, yb, mb) -> ModelState:
        params, opt_state, n_updates = state
        p = params.detach().requires_grad_(True)
        with torch.enable_grad():
            if self.remat:
                scores = checkpoint(self.apply, p, xb, use_reentrant=False)
            else:
                scores = self.apply(p, xb)
            loss = self.loss(scores, yb, mb).sum()
            (grad,) = torch.autograd.grad(loss, p)
        any_real = mb.sum(dim=1) > 0
        # The ages count before the gradient is adjusted, as in the JAX
        # handler.
        n_new = self._count_updates(n_updates, any_real)
        grad = self._adjust_gradient(grad, n_new)
        updates, opt_new = self.optimizer.update(grad, opt_state, params)
        stepped = ModelState(apply_updates(params, updates), opt_new, n_new)
        return select_state(any_real, stepped, state)

    def update(self, state: ModelState, data, perms: torch.Tensor
               ) -> ModelState:
        """Local training of every node.

        ``data = (X [N, S, ...], y [N, S], mask [N, S])``; ``perms``
        ``[N, max(local_epochs, 1), S]`` gives each node's shard order per
        epoch (with ``local_epochs=0``, the one order its key draws). When
        ``S`` is not a multiple of the batch size the order wraps and the
        wrapped tail is masked out, as in the JAX handler.
        """
        X, y, mask = data
        n, s = mask.shape
        rows = torch.arange(n, device=mask.device)[:, None]
        if self.local_epochs == 0:
            idx = perms[:, 0, :self.batch_size]
            return self._sgd_step(state, X[rows, idx], y[rows, idx],
                                  mask[rows, idx])
        B = self.batch_size or s
        n_batches = max(1, math.ceil(s / B))
        slots = torch.arange(n_batches * B, device=mask.device)
        wrap = slots % s
        slot_ok = (slots < s).to(mask.dtype)
        for e in range(self.local_epochs):
            order = perms[:, e, wrap]
            for i in range(n_batches):
                idx = order[:, i * B:(i + 1) * B]
                mb = mask[rows, idx] * slot_ok[i * B:(i + 1) * B]
                state = self._sgd_step(state, X[rows, idx], y[rows, idx], mb)
        return state

    # -- merging -----------------------------------------------------------

    def merge(self, state: ModelState, peer: PeerModel) -> ModelState:
        """Row-wise uniform average, age = max, the receiver's optimizer
        state (sgd.py:29-30, 163-166), written as the JAX package writes
        it, ``(a + b) / 2.0``, so it rounds the same."""
        return ModelState((state.params + peer.params) / 2.0,
                          state.opt_state,
                          torch.maximum(state.n_updates, peer.n_updates))

    # -- evaluation --------------------------------------------------------

    @torch.no_grad()
    def evaluate(self, state: ModelState, data) -> dict:
        """Metrics per node: ``{name: [N]}``."""
        X, y, mask = data
        scores = self.apply(state.params, X)
        return classification_metrics(scores, y, self.n_classes, mask)


class LimitedMergeSGDHandler(SGDHandler):
    """Limited merging (Danner 2023): when one model is more than
    ``age_diff_threshold`` updates older than the other, the older one is
    kept whole; otherwise the age-weighted average. Two age-0 models
    average plainly. The age becomes the larger one, the optimizer state
    stays the receiver's. Not a uniform average: the engine takes the
    plain deliver path."""

    uniform_avg_merge = False

    def __init__(self, *args, age_diff_threshold: int = 1, **kwargs):
        super().__init__(*args, **kwargs)
        self.L = age_diff_threshold

    def merge(self, state: ModelState, peer: PeerModel) -> ModelState:
        a1 = state.n_updates.to(torch.float32)
        a2 = peer.n_updates.to(torch.float32)
        tot = a1 + a2
        safe = torch.where(tot > 0, tot, torch.ones_like(tot))
        half = torch.full_like(tot, 0.5)
        w1 = torch.where(tot > 0, a1 / safe, half)[..., None]
        w2 = torch.where(tot > 0, a2 / safe, half)[..., None]
        keep_self = (a1 > a2 + self.L)[..., None]
        keep_peer = (a2 > a1 + self.L)[..., None]
        p1, p2 = state.params, peer.params
        avg = w1 * p1 + w2 * p2
        params = torch.where(keep_self, p1, torch.where(keep_peer, p2, avg))
        return ModelState(params, state.opt_state,
                          torch.maximum(state.n_updates, peer.n_updates))


class WeightedSGDHandler(SGDHandler):
    """Merge with caller-supplied weights over 1 + K models
    (``gossipy_tpu/handlers/sgd.py::WeightedSGDHandler``). Its pairwise
    merge stays the uniform average; the all-to-all simulator mixes the
    whole population with one matrix product instead."""

    def merge_many(self, state: ModelState, peers_params: torch.Tensor,
                   weights: torch.Tensor, peer_ages: torch.Tensor,
                   valid: torch.Tensor) -> ModelState:
        """Every row: ``w0 * own + sum_k w_k * peer_k`` over the valid
        slots, the weights renormalised over them; age = max of its own
        and the valid peers'. ``peers_params [N, K, stride]``, ``weights
        [N, K + 1]`` (own weight first), ``peer_ages [N, K]``, ``valid
        [N, K]``."""
        w0 = weights[:, 0]
        wk = weights[:, 1:] * valid.to(weights.dtype)
        total = w0 + wk.sum(dim=1)
        w0 = w0 / total
        wk = wk / total[:, None]
        params = w0[:, None] * state.params + \
            (wk[:, :, None] * peers_params).sum(dim=1)
        ages = torch.where(valid > 0, peer_ages, torch.zeros_like(peer_ages))
        n_up = torch.maximum(state.n_updates,
                             ages.amax(dim=1).clamp(min=0))
        return ModelState(params, state.opt_state, n_up)


class _PartialMergeCall:
    """Receive dispatch of the subset-merge handlers
    (``gossipy_tpu/handlers/sgd.py::_PartialMergeCall``): in UPDATE mode
    the received model trains on local data and only its subset (sample
    or partition) is then merged into the node's own; the other modes
    dispatch as :meth:`BaseHandler.call`."""

    def call(self, state: ModelState, peer: PeerModel, data, perms,
             extra=None) -> ModelState:
        if self.mode == CreateModelMode.UPDATE:
            recv = ModelState(peer.params, state.opt_state, peer.n_updates)
            trained = self.update(recv, data, perms)
            return self._merge(state, PeerModel(trained.params,
                                                trained.n_updates), extra)
        return super().call(state, peer, data, perms, extra)


class SamplingSGDHandler(_PartialMergeCall, SGDHandler):
    """Merge only a random subset of the coordinates (Hegedus 2021).

    ``extra`` is the ``[rows, stride]`` bool mask the simulator decodes
    from the message's sample seed (:func:`~gossipy_tpu_torch.compression.
    sample_mask`). The merge does not advance ``n_updates``. Not a uniform
    average: the engine takes the plain deliver path."""

    uniform_avg_merge = False

    def __init__(self, sample_size: float, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.mode == CreateModelMode.PASS:
            raise ValueError("Mode PASS not allowed for sampled models.")
        self.sample_size = sample_size

    def merge(self, state: ModelState, peer: PeerModel,
              extra=None) -> ModelState:
        if extra is None:
            raise ValueError("SamplingSGDHandler.merge needs a sample mask")
        return ModelState(sampled_merge(state.params, peer.params, extra),
                          state.opt_state, state.n_updates)


class PartitionedSGDHandler(_PartialMergeCall, SGDHandler):
    """Partitioned model exchange (Hegedus 2021).

    - ``n_updates`` is an int32 age per part, ``[P]`` a node (``[N, P]``
      stacked); every step ages all parts by one;
    - each gradient coordinate is divided by the age of its part;
    - ``merge`` averages the one part named by ``extra`` (``[rows]``
      partition ids), weighted by the two ages of that part, whose age
      becomes the larger one.
    Not a uniform average: the engine takes the plain deliver path."""

    uniform_avg_merge = False

    def __init__(self, partition: ModelPartition, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.mode == CreateModelMode.PASS:
            raise ValueError("Mode PASS not allowed for partitioned models.")
        self.partition = partition

    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> ModelState:
        st = super().init(generator, device)
        return ModelState(st.params, st.opt_state,
                          torch.zeros(self.partition.n_parts,
                                      dtype=torch.int32,
                                      device=st.params.device))

    def _count_updates(self, n_updates, any_real):
        return n_updates + any_real.to(n_updates.dtype)[:, None]

    def _adjust_gradient(self, grad, n_updates):
        ages = torch.clamp(n_updates.to(torch.float32), min=1.0)
        cols = self.partition.columns(grad.device).clamp(min=0)
        return grad / ages[:, cols]

    def merge(self, state: ModelState, peer: PeerModel,
              extra=None) -> ModelState:
        if extra is None:
            raise ValueError("PartitionedSGDHandler.merge needs a partition "
                             "id")
        pid = extra.long() % self.partition.n_parts
        rows = torch.arange(pid.shape[0], device=pid.device)
        a1 = state.n_updates[rows, pid]
        a2 = peer.n_updates[rows, pid]
        params = self.partition.merge(state.params, peer.params, pid,
                                      weights=(a1, a2))
        n_up = state.n_updates.clone()
        n_up[rows, pid] = torch.maximum(a1, a2)
        return ModelState(params, state.opt_state, n_up)
