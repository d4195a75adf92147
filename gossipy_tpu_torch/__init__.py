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
``device="cpu"``; without a card it raises instead of falling back.
"""

from __future__ import annotations

import logging
import random as _py_random

import numpy as np
import torch

__version__ = "0.1.0"

LOG = logging.getLogger("gossipy_tpu_torch")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default.

    ``None`` means the card; it raises when CUDA is not available, so a run
    never lands on the CPU by accident. Pass ``device="cpu"`` (as the tests
    do) to run the plain PyTorch versions on the host.
    """
    dev = torch.device("cuda" if device is None else device)
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
