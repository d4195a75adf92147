"""Handler state: what a node holds and what a message carries.

Counterpart of ``gossipy_tpu/handlers/base.py``. A node's parameters are
one flat float32 row (:class:`~gossipy_tpu_torch.models.nn.ParamLayout`);
a population stacks the rows to ``[N, stride]``. The ported handlers use
plain SGD, so there is no optimizer state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


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
