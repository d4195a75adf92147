"""Handler state and the receive-time dispatch.

Counterpart of ``gossipy_tpu/handlers/base.py``. A node's parameters are
one flat float32 row (:class:`~gossipy_tpu_torch.models.nn.ParamLayout`);
a population stacks the rows to ``[N, stride]``, and its optimizer state
is a tuple of per-node tensors (:mod:`gossipy_tpu_torch.optim`).

The JAX handler is written for one node and vmapped by the engine; a port
handler takes the whole population (or a gathered subset of it) at once,
and its local update takes shard orders drawn by the engine's
:class:`~gossipy_tpu_torch.random.DrawProvider` in place of a key.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import CreateModelMode
from ..models.nn import ParamLayout


class ModelState(NamedTuple):
    """One node's (or, stacked, every node's) learning state.

    - ``params``: flat float32 parameters, ``[stride]`` or ``[N, stride]``
    - ``opt_state``: the optimizer's state, a tuple of tensors with a
      leading node axis when stacked (``()`` for a stateless rule)
    - ``n_updates``: int32 age, ``[]`` or ``[N]`` (a partitioned
      handler's age vector: ``[P]`` or ``[N, P]``)
    """

    params: torch.Tensor
    opt_state: tuple
    n_updates: torch.Tensor


class PeerModel(NamedTuple):
    """What travels in a message: the sender's params and age snapshot."""

    params: torch.Tensor
    n_updates: torch.Tensor


class BaseHandler:
    """Receive-time dispatch on the create-model mode (base.py:93-112).

    Subclasses set ``layout`` (the :class:`ParamLayout` of a node's flat
    row) and define ``init(generator, device)``, ``update(state, data,
    perms)``, ``merge(state, peer)`` and ``evaluate(state, data)``, the
    last three over stacked rows. What the engine asks of every handler
    beyond those has a default here: no optimizer state
    (:meth:`init_opt_state`), an update that draws no shard orders
    (:meth:`orders_per_update`; it then receives ``perms=None``), a
    message of the row's real width (:meth:`get_size`), and a merge the
    fused kernels may not replace (``uniform_avg_merge``,
    ``merge_peer_weight``).
    """

    mode: CreateModelMode = CreateModelMode.MERGE_UPDATE
    layout: ParamLayout
    # True when ``merge`` is exactly the two-way blend ``(1 - w) * own +
    # w * peer`` with age = max, ``w = merge_peer_weight``: the engine's
    # fused kernels may then replace it.
    uniform_avg_merge: bool = False
    merge_peer_weight: Optional[float] = None

    def init_opt_state(self, params: torch.Tensor) -> tuple:
        """The optimizer state of rows ``params`` (``[N, stride]``) before
        any step: none by default."""
        return ()

    def orders_per_update(self) -> Optional[int]:
        """The ``epochs`` of the shard orders one local update takes from
        the engine's draw provider, or None when it draws none (the JAX
        handler ignores its key)."""
        return None

    def get_size(self) -> int:
        """Scalars a message carries (message-size accounting)."""
        return self.layout.width

    def _merge(self, state: ModelState, peer: PeerModel, extra=None
               ) -> ModelState:
        """``merge``, passing the message's decoded ``extra`` only to a
        handler whose merge reads one (a partition id, a sample mask)."""
        if extra is None:
            return self.merge(state, peer)
        return self.merge(state, peer, extra)

    def call(self, state: ModelState, peer: PeerModel, data,
             perms: torch.Tensor, extra=None) -> ModelState:
        """What every row of ``state`` becomes on receiving the matching
        row of ``peer``; the received model trains with the node's own
        optimizer state, as in the JAX ``call``; ``extra`` (row-aligned,
        or None) goes to the merge:

        - UPDATE: the received model, trained on local data;
        - MERGE_UPDATE: own and received model merged, then trained;
        - UPDATE_MERGE: own and received model each trained, then merged.
          The JAX handler splits the node's key in two; here ``perms``
          holds both halves' shard orders, ``[N, 2 E, S]``: the first
          ``E`` rows train the own model, the last ``E`` the received one;
        - PASS: the received model as it is.
        """
        if self.mode == CreateModelMode.UPDATE:
            recv = ModelState(peer.params, state.opt_state, peer.n_updates)
            return self.update(recv, data, perms)
        if self.mode == CreateModelMode.MERGE_UPDATE:
            return self.update(self._merge(state, peer, extra), data, perms)
        if self.mode == CreateModelMode.UPDATE_MERGE:
            if perms is None:
                own_perms = peer_perms = None
            else:
                e = perms.shape[1] // 2
                own_perms, peer_perms = perms[:, :e], perms[:, e:]
            mine = self.update(state, data, own_perms)
            recv = ModelState(peer.params, state.opt_state, peer.n_updates)
            theirs = self.update(recv, data, peer_perms)
            return self._merge(mine, PeerModel(theirs.params,
                                               theirs.n_updates), extra)
        if self.mode == CreateModelMode.PASS:
            return ModelState(peer.params, state.opt_state, peer.n_updates)
        raise ValueError(f"unknown create model mode {self.mode}")


def select_rows(cond: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """``cond ? a : b`` row by row (``cond`` is ``[N]``)."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - 1)), a, b)


def select_state(cond: torch.Tensor, a: ModelState,
                 b: ModelState) -> ModelState:
    """``cond ? a : b`` row by row over every tensor of the state."""
    return ModelState(select_rows(cond, a.params, b.params),
                      tuple(select_rows(cond, x, y)
                            for x, y in zip(a.opt_state, b.opt_state)),
                      select_rows(cond, a.n_updates, b.n_updates))
