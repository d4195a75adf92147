"""Handler state and the receive-time dispatch.

Counterpart of ``gossipy_tpu/handlers/base.py``. A node's parameters are
one flat float32 row (:class:`~gossipy_tpu_torch.models.nn.ParamLayout`);
a population stacks the rows to ``[N, stride]``. The ported handlers use
plain SGD, so there is no optimizer state.

The JAX handler is written for one node and vmapped by the engine; a port
handler takes the whole population (or a gathered subset of it) at once,
and its local update takes shard orders drawn by the engine's
:class:`~gossipy_tpu_torch.random.DrawProvider` in place of a key.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import CreateModelMode


class ModelState(NamedTuple):
    """One node's (or, stacked, every node's) learning state.

    - ``params``: flat float32 parameters, ``[stride]`` or ``[N, stride]``
    - ``n_updates``: int32 age, ``[]`` or ``[N]``
    """

    params: torch.Tensor
    n_updates: torch.Tensor


class PeerModel(NamedTuple):
    """What travels in a message: the sender's params and age snapshot."""

    params: torch.Tensor
    n_updates: torch.Tensor


class BaseHandler:
    """Receive-time dispatch on the create-model mode (base.py:93-112).

    Subclasses define ``update(state, data, perms)`` and
    ``merge(state, peer)``, both over stacked rows.
    """

    mode: CreateModelMode = CreateModelMode.MERGE_UPDATE

    def call(self, state: ModelState, peer: PeerModel, data,
             perms: torch.Tensor) -> ModelState:
        """What every row of ``state`` becomes on receiving the matching
        row of ``peer``:

        - UPDATE: the received model, trained on local data;
        - MERGE_UPDATE: own and received model merged, then trained;
        - PASS: the received model as it is.

        UPDATE_MERGE trains two models per node, which needs a second
        stream of shard orders per node (the JAX handler splits the call
        key); it is not ported yet and raises.
        """
        if self.mode == CreateModelMode.UPDATE:
            return self.update(ModelState(peer.params, peer.n_updates), data,
                               perms)
        if self.mode == CreateModelMode.MERGE_UPDATE:
            return self.update(self.merge(state, peer), data, perms)
        if self.mode == CreateModelMode.PASS:
            return ModelState(peer.params, peer.n_updates)
        if self.mode == CreateModelMode.UPDATE_MERGE:
            raise NotImplementedError(
                "CreateModelMode.UPDATE_MERGE is not ported yet")
        raise ValueError(f"unknown create model mode {self.mode}")
