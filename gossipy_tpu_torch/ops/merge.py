"""Multi-slot gather-merge: the deliver phase's one kernel.

Counterpart of ``gossipy_tpu/ops/merge.py``'s multi-slot form. For every
receiver row ``i`` the K slots of its mailbox cell fold left to right,

    ``out = p[i]``; for each slot ``k``:
    ``out = w_self[i, k] * out + (w_peer[i, k] != 0 ? w_peer[i, k] * h[idx[i, k]] : 0)``

with ``h`` the flat ``[D*N, F]`` snapshot ring. Empty slots carry
``(w_self, w_peer) = (1, 0)``; the ring row behind their index is never
used, even when it is not finite.

- :func:`gather_merge_multi_reference` is the plain PyTorch version.
- :func:`gather_merge_multi` is the wrapper: on CPU tensors it runs the
  plain version; on CUDA tensors it launches the kernel
  ``csrc/gather_merge_multi.cu`` (built at first use) or raises. It never
  falls back from the card to the plain version.
- :func:`gather_merge_multi_pytree` takes per-leaf dicts, as the JAX
  package's pytree form does, and makes one launch over their
  concatenation. The engine does not need it: it keeps each node's
  parameters in one flat row already.

Every launch adds one to ``LAUNCHES["gather_merge_multi"]``.
"""

from __future__ import annotations

import collections
import ctypes
import math

import torch

from . import _build

KERNEL = "gather_merge_multi"
MAX_SLOTS = 64  # kMaxSlots in the CUDA source

# Kernel launches per wrapper, counted where the wrapper launches and
# nowhere else.
LAUNCHES: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def gather_merge_multi_reference(p: torch.Tensor, h: torch.Tensor,
                                 idx: torch.Tensor, w_self: torch.Tensor,
                                 w_peer: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the same fold, one slot at a time, with the
    peer rows gathered (``p [N, F]``, ``h [M, F]``, tables ``[N, K]``)."""
    out = p
    for k in range(idx.shape[1]):
        peer = h[idx[:, k].long()]
        wp = w_peer[:, k].to(p.dtype)[:, None]
        contrib = torch.where(wp != 0, wp * peer, torch.zeros_like(peer))
        out = w_self[:, k].to(p.dtype)[:, None] * out + contrib
    return out


def _check(p, h, idx, w_self, w_peer):
    if idx.dim() != 2:
        raise ValueError(f"idx must be [N, K], got shape {tuple(idx.shape)}")
    n, k = idx.shape
    if p.dim() != 2 or h.dim() != 2 or p.shape[0] != n \
            or h.shape[1] != p.shape[1]:
        raise ValueError(f"shapes do not fit: p {tuple(p.shape)}, "
                         f"h {tuple(h.shape)}, idx {tuple(idx.shape)}")
    if tuple(w_self.shape) != (n, k) or tuple(w_peer.shape) != (n, k):
        raise ValueError("w_self and w_peer must be [N, K] like idx")
    devices = {t.device for t in (p, h, idx, w_self, w_peer)}
    if len(devices) != 1:
        raise ValueError(f"all operands must be on one device, got {devices}")


def gather_merge_multi_cuda(p: torch.Tensor, h: torch.Tensor,
                            idx: torch.Tensor, w_self: torch.Tensor,
                            w_peer: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel; returns a new ``[N, F]`` tensor.

    Live indices must lie in ``[0, M)``. Raises on an operand the kernel
    does not take and when the launch reports an error.
    """
    _check(p, h, idx, w_self, w_peer)
    if not p.is_cuda:
        raise ValueError("gather_merge_multi_cuda takes CUDA tensors")
    if p.dtype != torch.float32 or h.dtype != torch.float32:
        raise TypeError("the kernel merges float32 params and ring rows")
    if not (p.is_contiguous() and h.is_contiguous()):
        raise ValueError("p and h must be contiguous")
    n, k = idx.shape
    if k > MAX_SLOTS:
        raise ValueError(f"at most {MAX_SLOTS} slots, got {k}")
    f = p.shape[1]
    idx32 = idx.to(torch.int32).contiguous()
    ws = w_self.to(torch.float32).contiguous()
    wp = w_peer.to(torch.float32).contiguous()
    out = torch.empty_like(p)
    fn = _kernel()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = fn(p.data_ptr(), h.data_ptr(), idx32.data_ptr(), ws.data_ptr(),
                wp.data_ptr(), out.data_ptr(), n, f, k, stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {rc}")
    LAUNCHES[KERNEL] += 1
    return out


def _kernel():
    lib = _build.load(KERNEL)
    fn = lib.gather_merge_multi
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gather_merge_multi(p: torch.Tensor, h: torch.Tensor, idx: torch.Tensor,
                       w_self: torch.Tensor,
                       w_peer: torch.Tensor) -> torch.Tensor:
    """K-slot gather-merge in one pass: the kernel on CUDA tensors, the
    plain version on CPU tensors. Returns a new tensor; ``p`` is not
    modified."""
    _check(p, h, idx, w_self, w_peer)
    if p.device.type == "cpu":
        return gather_merge_multi_reference(p, h, idx, w_self, w_peer)
    if p.device.type != "cuda":
        raise ValueError(f"no gather_merge_multi for device {p.device}")
    return gather_merge_multi_cuda(p, h, idx, w_self, w_peer)


def gather_merge_multi_pytree(params: dict, history: dict,
                              flat_idx: torch.Tensor, w_self: torch.Tensor,
                              w_peer: torch.Tensor) -> dict:
    """:func:`gather_merge_multi` over named leaves in one launch:
    ``params`` leaves are ``[N, ...]``, ``history`` leaves ``[D, N', ...]``
    (the snapshot ring, addressed as a flat ``[D*N', F]`` table by
    ``flat_idx[i, k] = (send_round % D) * N' + sender``). Leaves are
    concatenated, merged and split back."""
    names = list(params)
    n = params[names[0]].shape[0]
    h0 = history[names[0]]
    m = h0.shape[0] * h0.shape[1]
    widths = [math.prod(params[k].shape[1:]) for k in names]
    p_cat = torch.cat([params[k].reshape(n, -1) for k in names], dim=1)
    h_cat = torch.cat([history[k].reshape(m, -1) for k in names], dim=1)
    out = gather_merge_multi(p_cat, h_cat, flat_idx, w_self, w_peer)
    parts = torch.split(out, widths, dim=1)
    return {k: part.reshape(params[k].shape) for k, part in zip(names, parts)}
