"""Masked loss functions.

Counterpart of ``gossipy_tpu/handlers/losses.py``. A loss maps
``(scores [..., B, C], y [..., B], mask [..., B])`` to one value per
leading index (one per node when the leading axis is the node axis);
``mask`` weights out shard padding and an all-padding batch gives 0.
"""

from __future__ import annotations

from typing import Optional

import torch


def _masked_mean(v: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return v.mean(dim=-1)
    m = mask.to(v.dtype)
    denom = m.sum(dim=-1)
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    return torch.where(denom > 0, (v * m).sum(dim=-1) / safe,
                       torch.zeros_like(denom))


def cross_entropy(scores: torch.Tensor, y: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Log-softmax over the last axis plus negative log-likelihood, with
    integer labels ``[..., B]`` or one-hot labels ``[..., B, C]``."""
    logp = torch.log_softmax(scores, dim=-1)
    if y.dim() == scores.dim():
        nll = -(y * logp).sum(dim=-1)
    else:
        nll = -torch.gather(logp, -1, y.unsqueeze(-1).long())[..., 0]
    return _masked_mean(nll, mask)


def mse(scores: torch.Tensor, y: torch.Tensor,
        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean squared error over the last axis of ``scores [..., B, C]``
    against ``y [..., B, C]``, or ``y [..., B]`` taken as one column."""
    if y.dim() < scores.dim():
        y = y.unsqueeze(-1)
    err = ((scores - y) ** 2).mean(dim=-1)
    return _masked_mean(err, mask)


def binary_cross_entropy(scores: torch.Tensor, y: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Binary cross-entropy of probability outputs (``[..., B, 1]`` or
    ``[..., B]``, clipped to ``[1e-7, 1 - 1e-7]``) against 0/1 labels
    ``[..., B]``."""
    s = scores.squeeze(-1) if scores.dim() > y.dim() else scores
    s = s.clamp(1e-7, 1 - 1e-7)
    y = y.to(s.dtype)
    nll = -(y * torch.log(s) + (1 - y) * torch.log(1 - s))
    return _masked_mean(nll, mask)
