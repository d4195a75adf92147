"""gossipy_tpu_torch — the gossip-learning simulator on PyTorch and CUDA.

A port of :mod:`gossipy_tpu` (JAX, TPU) to PyTorch on an NVIDIA Hopper
card. The module names mirror the JAX package's so each piece has an
obvious counterpart; inside, the code is plain PyTorch: stacked per-node
tensors with a leading node axis, an explicit ``device=`` everywhere and
an explicit ``torch.Generator`` for every random draw. The JAX package's
TPU kernels (the gather-merges of ``ops/merge.py`` and the flash-attention
hop of ``ops/attention.py``) are CUDA C++ kernels in ``csrc/``, built with
``nvcc`` at first use.

This package imports nothing of JAX and nothing of :mod:`gossipy_tpu`.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (or names the host in :class:`GlobalSettings`); without a
card it raises instead of falling back.
"""

from __future__ import annotations

import logging
import random as _py_random

import numpy as np
import torch

__version__ = "0.1.0"

class DuplicateFilter(logging.Filter):
    """Suppress repeated log records: a message already seen is dropped
    (the JAX package's filter, as the original gossipy's)."""

    def __init__(self):
        super().__init__()
        self._seen: set[str] = set()

    def filter(self, record: logging.LogRecord) -> bool:
        msg = record.getMessage()
        if msg in self._seen:
            return False
        self._seen.add(msg)
        return True


LOG = logging.getLogger("gossipy_tpu_torch")
LOG.addFilter(DuplicateFilter())


class GlobalSettings:
    """The process's default device, a singleton (the original gossipy's
    device singleton; the JAX package's records a platform string).

    :meth:`get_device` is ``"cuda"`` unless :meth:`set_device` named the
    host (``"cpu"``); :func:`resolve_device` reads it for every entry point
    called without ``device=``. Nothing falls back to the CPU because no
    card was found: :meth:`auto_device` picks the card, and raises without
    one.
    """

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance._device = None
        return cls._instance

    def set_device(self, device: str | None = None) -> None:
        """``"cuda"``, ``"cpu"``, or None for the default (the card)."""
        if device is not None and str(device).split(":")[0] not in (
                "cuda", "cpu"):
            raise ValueError(f"unsupported device {device!r}; use 'cuda' "
                             "or 'cpu'")
        self._device = None if device is None else str(device)

    def auto_device(self) -> str:
        """Select the card (the original's ``auto_device`` prefers CUDA);
        raises when no CUDA device is available."""
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; name the host with "
                "GlobalSettings().set_device('cpu')")
        self._device = "cuda"
        return self._device

    def get_device(self) -> str:
        return self._device or "cuda"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device``, else
    :meth:`GlobalSettings.get_device` (``cuda`` by default).

    The card raises when CUDA is not available, so a run never lands on
    the CPU by accident. Pass ``device="cpu"`` (as the tests do), or
    ``GlobalSettings().set_device("cpu")``, to run the plain PyTorch
    versions on the host.
    """
    dev = torch.device(GlobalSettings().get_device() if device is None
                       else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gossipy_tpu_torch runs on CUDA by default and no CUDA device "
            "is available; pass device='cpu' to run on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def set_seed(seed: int = 42) -> torch.Generator:
    """Seed the host RNGs and return a CPU ``torch.Generator``.

    Counterpart of ``gossipy_tpu.set_seed``, which returns a root JAX key:
    here the root of every simulation draw is an explicit generator.
    """
    _py_random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)
