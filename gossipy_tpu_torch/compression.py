"""Model partitions and coordinate-sampled merges over flat rows.

Counterpart of ``gossipy_tpu/compression.py``. A node's parameters are
one flat row (:class:`~gossipy_tpu_torch.models.nn.ParamLayout`) whose
columns ``[0, width)`` are the JAX package's flat coordinates in its leaf
order; the padding columns ``[width, stride)`` belong to no partition and
to no sample, so no merge ever writes them.

- :class:`ModelPartition`: coordinate ``c`` belongs to part ``c *
  n_parts // width`` (contiguous blocks whose sizes differ by at most
  one), as in the JAX partition; its merge is the weighted average of one
  part of two rows.
- :func:`sample_mask`: the Bernoulli(``sample_size``) coordinate mask of
  a sampled merge as a function of a 31-bit payload carried by the
  message: a counter-based hash of (payload, column) on the device. The
  JAX package derives the mask from ``fold_in(PRNGKey(0x5A11), payload)``
  with ``jax.random``; the two masks have the same law but not the same
  bits, so a test replays the JAX one through its draw provider.
- :func:`sampled_merge`: average the masked coordinates, keep the rest.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .models.nn import ParamLayout

_M32 = 0xFFFFFFFF


class ModelPartition:
    """Equal-size partition of a layout's ``width`` coordinates into
    ``n_parts`` contiguous parts (``min(n_parts, width)``).

    ``part_of`` is the ``[stride]`` int64 part id of each column, ``-1``
    on the padding columns; ``sizes`` counts each part's coordinates.
    """

    def __init__(self, layout: ParamLayout, n_parts: int):
        total = layout.width
        self.n_parts = int(min(n_parts, total))
        ids = np.full(layout.stride, -1, dtype=np.int64)
        ids[:total] = np.arange(total, dtype=np.int64) * self.n_parts // total
        self.part_of = torch.from_numpy(ids)
        self.sizes = np.bincount(ids[:total], minlength=self.n_parts)
        self._on = {}

    def columns(self, device) -> torch.Tensor:
        """``part_of`` on ``device`` (copied once per device)."""
        key = str(device)
        if key not in self._on:
            self._on[key] = self.part_of.to(device)
        return self._on[key]

    def merge(self, params1: torch.Tensor, params2: torch.Tensor,
              id_part: torch.Tensor,
              weights: Optional[tuple] = None) -> torch.Tensor:
        """Rows ``params1`` with part ``id_part`` (``[rows]``, taken modulo
        ``n_parts``) replaced by the weighted average of both rows: the
        weights (the two ages, ``[rows]``) are normalised, and ``(0, 0)``
        averages plainly."""
        rows = params1.shape[0]
        if weights is None:
            w1 = w2 = torch.full((rows,), 0.5, device=params1.device)
        else:
            a1 = weights[0].to(torch.float32)
            a2 = weights[1].to(torch.float32)
            tot = a1 + a2
            safe = torch.where(tot > 0, tot, torch.ones_like(tot))
            half = torch.full_like(tot, 0.5)
            w1 = torch.where(tot > 0, a1 / safe, half)
            w2 = torch.where(tot > 0, a2 / safe, half)
        pid = id_part.long() % self.n_parts
        avg = w1[:, None] * params1 + w2[:, None] * params2
        hit = self.columns(params1.device)[None, :] == pid[:, None]
        return torch.where(hit, avg, params1)


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser on int64 tensors holding values in
    ``[0, 2^32)``: the products wrap in int64, the mask keeps the low 32
    bits."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def sample_mask(payload: torch.Tensor, layout: ParamLayout,
                sample_size: float) -> torch.Tensor:
    """``[rows, stride]`` bool: column ``c < width`` of row ``i`` is
    sampled iff the top 24 bits of ``fmix32(fmix32(payload_i) ^ c *
    0x9E3779B1)`` over ``2^24`` fall below ``sample_size``; padding
    columns never are. A function of the payload alone, made on the
    payload's device."""
    dev = payload.device
    seed = _fmix32(payload.long() & _M32)
    cols = torch.arange(layout.stride, dtype=torch.int64, device=dev)
    h = _fmix32(seed[:, None] ^ ((cols * 0x9E3779B1) & _M32)[None, :])
    u = (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return (u < sample_size) & (cols < layout.width)[None, :]


def sampled_merge(params1: torch.Tensor, params2: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """In the masked coordinates ``(p1 + p2) / 2``, elsewhere ``p1``."""
    return torch.where(mask, (params1 + params2) / 2.0, params1)
