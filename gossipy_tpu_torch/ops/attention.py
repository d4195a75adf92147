"""Flash attention: the ring-attention hop update with the score block kept
on chip.

Counterpart of ``gossipy_tpu/ops/attention.py``. One hop absorbs a
key/value chunk into the per-query streaming-softmax carry ``(m, l, acc)``
(running max, normalizer, weighted-value accumulator):

    s = scale * q k^T, masked to _NEG for padded keys and, when causal,
        where k_off + j > q_off + i (global positions);
    m_new = max(m, rowmax(s));  alpha = exp(m - m_new);
    p = exp(s - m_new), zeroed where masked;
    acc = alpha * acc + p v;  l = alpha * l + rowsum(p);  m = m_new.

:func:`flash_hop_update` follows the TPU kernel (``_hop_kernel``, K5),
which zeroes ``p`` on masked entries; :func:`hop_update_reference` follows
the JAX package's plain jnp body, which does not. The two differ on a row
whose whole chunk is masked while its incoming ``m`` is ``_NEG``: there the
plain body adds ``exp(0) = 1`` to ``l`` per masked key and the kernel adds
nothing.

K5 is CUDA C++ in ``csrc/flash_hop.cu``, built at first use. On CPU
tensors :func:`flash_hop_update` runs the plain version of the kernel,
:func:`flash_hop_update_reference`, which streams over key blocks of
``block_k`` as the TPU kernel does. On CUDA tensors it launches K5 or
raises. Every launch adds one to ``LAUNCHES["flash_hop"]``.

The gradient is the JAX package's hand-derived backward (``_hop_bwd_math``)
in plain PyTorch under :class:`torch.autograd.Function`: it recomputes the
score block from the saved inputs and materialises ``[sl_q, sl_k]``
matrices, as the JAX backward does. No backward kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Union

import torch

from . import _build
from ._build import LAUNCHES

# Finite stand-in for -inf: exp() stays NaN-free (as in the JAX package).
_NEG = -1e30
# The TPU kernel's tiles: query rows per program, key rows per streamed
# block. The plain version streams over key blocks of BLOCK_K, so its carry
# is rescaled where the TPU kernel's is; K5 has its own, smaller tiles
# (csrc/flash_hop.cu), which changes rounding only.
BLOCK_Q = 128
BLOCK_K = 512

KERNEL = "flash_hop"
# The csrc/ source (without .cu) that holds each kernel's entry point.
SOURCES = {KERNEL: "flash_hop"}
MAX_DIM = 256      # kMaxDim in csrc/flash_hop.cu: D and Dv up to this
INPUT_FORMATS = {torch.float32: 0, torch.bfloat16: 1}

Offset = Union[int, torch.Tensor]


def _offset(x: Offset) -> int:
    """An offset as a Python int: a 0-d tensor is read once (on a CUDA
    tensor that read synchronises with the card)."""
    if isinstance(x, torch.Tensor):
        if x.dim() != 0:
            raise ValueError(f"an offset must be an int or a 0-d tensor, got "
                             f"shape {tuple(x.shape)}")
        return int(x.item())
    return int(x)


def _work_dtype(*tensors) -> torch.dtype:
    """float32, as the JAX package computes; float64 when an operand is
    float64 (for gradient checks in double precision)."""
    if any(t.dtype == torch.float64 for t in tensors):
        return torch.float64
    return torch.float32


def _causal_mask(sl_q: int, sl_k: int, q_off: int, k_off: int,
                 device) -> torch.Tensor:
    """``[sl_q, sl_k]``: True where key ``k_off + j`` lies after query
    ``q_off + i``."""
    q_pos = q_off + torch.arange(sl_q, device=device)
    k_pos = k_off + torch.arange(sl_k, device=device)
    return k_pos[None, :] > q_pos[:, None]


def _check_hop(q, k_c, v_c, m, l, acc) -> None:
    if q.dim() != 2 or k_c.dim() != 2 or v_c.dim() != 2:
        raise ValueError("q, k_c and v_c must be [rows, features]")
    sl_q, dim = q.shape
    sl_k, dv = v_c.shape
    if k_c.shape != (sl_k, dim):
        raise ValueError(f"k_c {tuple(k_c.shape)} must be [{sl_k}, {dim}]")
    if sl_q == 0 or sl_k == 0 or dim == 0 or dv == 0:
        raise ValueError("empty attention operands")
    if m.shape != (sl_q,) or l.shape != (sl_q,) or acc.shape != (sl_q, dv):
        raise ValueError(f"carry shapes m {tuple(m.shape)}, l "
                         f"{tuple(l.shape)}, acc {tuple(acc.shape)} do not "
                         f"fit q [{sl_q}, {dim}] and v_c [{sl_k}, {dv}]")
    devices = {t.device for t in (q, k_c, v_c, m, l, acc)}
    if len(devices) != 1:
        raise ValueError(f"all operands must be on one device, got {devices}")


# -- plain versions -----------------------------------------------------------

def hop_update_reference(q, k_c, v_c, m, l, acc, q_off: Offset,
                         k_off: Offset, scale: float, causal: bool):
    """The JAX package's plain hop body (``hop_update_reference``): one
    dense block, ``p`` not zeroed where masked. Returns ``(m, l, acc)``."""
    wd = _work_dtype(q, k_c, v_c, m, l, acc)
    s = (q.to(wd) @ k_c.to(wd).T) * scale
    if causal:
        s = torch.where(_causal_mask(q.shape[0], k_c.shape[0], _offset(q_off),
                                     _offset(k_off), q.device), _NEG, s)
    m_new = torch.maximum(m, s.amax(dim=1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[:, None])
    acc = acc * alpha[:, None] + p @ v_c.to(wd)
    l = l * alpha + p.sum(dim=1)
    return m_new, l, acc


def flash_hop_update_reference(q, k_c, v_c, m, l, acc, q_off: Offset,
                               k_off: Offset, scale: float,
                               causal: bool = False, block_k: int = BLOCK_K):
    """Plain PyTorch version of K5, on any device: the TPU kernel's
    arithmetic, streamed over key blocks of ``min(block_k, sl_k)`` with the
    carry rescaled after each block; masked entries are ``_NEG`` in the
    scores and 0 in ``p``. All query rows go at once (query tiling changes
    no row's arithmetic), and the ragged last block is just shorter (the
    TPU kernel's padded keys are masked). Computes in float32 (float64 for
    float64 operands); returns the carry ``(m, l, acc)``."""
    _check_hop(q, k_c, v_c, m, l, acc)
    if block_k < 1:
        raise ValueError(f"block_k must be positive, got {block_k}")
    q_off, k_off = _offset(q_off), _offset(k_off)
    wd = _work_dtype(q, k_c, v_c, m, l, acc)
    qf = q.to(wd)
    m, l, acc = m.to(wd), l.to(wd), acc.to(wd)
    sl_q, sl_k = q.shape[0], k_c.shape[0]
    bk = min(block_k, sl_k)
    for start in range(0, sl_k, bk):
        stop = min(start + bk, sl_k)
        s = (qf @ k_c[start:stop].to(wd).T) * scale
        masked = None
        if causal:
            masked = _causal_mask(sl_q, stop - start, q_off, k_off + start,
                                  q.device)
            s = torch.where(masked, _NEG, s)
        m_new = torch.maximum(m, s.amax(dim=1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[:, None])
        if masked is not None:
            p = torch.where(masked, 0.0, p)
        acc = acc * alpha[:, None] + p @ v_c[start:stop].to(wd)
        l = l * alpha + p.sum(dim=1)
        m = m_new
    return m, l, acc


# -- K5 -----------------------------------------------------------------------

def flash_hop_update_cuda(q, k_c, v_c, m, l, acc, q_off: Offset,
                          k_off: Offset, scale: float, causal: bool = False):
    """Launch K5; returns new float32 tensors ``(m, l, acc)``.

    ``q``, ``k_c``, ``v_c`` are float32 or bfloat16 (one type), widened to
    float32 in the kernel; the carry is float32. ``D`` and ``Dv`` are at
    most :data:`MAX_DIM`. Raises on an operand the kernel does not take and
    when the launch reports an error."""
    _check_hop(q, k_c, v_c, m, l, acc)
    if q.dtype not in INPUT_FORMATS or k_c.dtype != q.dtype \
            or v_c.dtype != q.dtype:
        raise TypeError(f"K5 takes q, k_c and v_c of one type, float32 or "
                        f"bfloat16; got {q.dtype}, {k_c.dtype}, {v_c.dtype}")
    if any(t.dtype != torch.float32 for t in (m, l, acc)):
        raise TypeError("K5 takes a float32 carry (m, l, acc)")
    sl_q, dim = q.shape
    sl_k, dv = v_c.shape
    if dim > MAX_DIM or dv > MAX_DIM:
        raise ValueError(f"K5 takes D and Dv up to {MAX_DIM}, got {dim} and "
                         f"{dv}")
    if not q.is_cuda:
        raise ValueError("flash_hop_update_cuda takes CUDA tensors")
    q_off, k_off = _offset(q_off), _offset(k_off)
    q, k_c, v_c, m, l, acc = (t.contiguous() for t in (q, k_c, v_c, m, l,
                                                       acc))
    m_out, l_out, acc_out = (torch.empty_like(t) for t in (m, l, acc))
    fn = _build.function(SOURCES[KERNEL], "flash_hop",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int]
                         + [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 6
                         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_c.data_ptr(), v_c.data_ptr(),
                INPUT_FORMATS[q.dtype], m.data_ptr(), l.data_ptr(),
                acc.data_ptr(), m_out.data_ptr(), l_out.data_ptr(),
                acc_out.data_ptr(), sl_q, sl_k, dim, dv, q_off, k_off,
                float(scale), int(bool(causal)), _build.stream(q))
    _build.raise_if_failed(KERNEL, rc)
    LAUNCHES[KERNEL] += 1
    return m_out, l_out, acc_out


# -- gradient -----------------------------------------------------------------

def _hop_backward(scale, causal, q, k_c, v_c, m_in, l_in, acc_in, q_off,
                  k_off, gm, gl, gacc):
    """The JAX package's ``_hop_bwd_math`` (attention.py:205-253) as
    written: recompute ``s``, ``M``, ``A``, ``P``; route the max to ``m_in``
    where ``m_in >= rowmax(s)``, else split it evenly over tied argmax
    entries; zero ``ds`` on causally masked entries. Like the JAX backward
    it has no ``p`` guard, so on a fully masked row with ``m_in = _NEG`` it
    is not the derivative of the kernel's forward. Returns ``(dq, dk, dv,
    dm_in, dl_in, dacc_in)`` in the working type."""
    wd = _work_dtype(q, k_c, v_c, m_in, l_in, acc_in)
    gm, gl, gacc = gm.to(wd), gl.to(wd), gacc.to(wd)
    m_in, l_in, acc_in = m_in.to(wd), l_in.to(wd), acc_in.to(wd)
    qf, kf, vf = q.to(wd), k_c.to(wd), v_c.to(wd)

    s = (qf @ kf.T) * scale
    masked = None
    if causal:
        masked = _causal_mask(q.shape[0], k_c.shape[0], q_off, k_off,
                              q.device)
        s = torch.where(masked, _NEG, s)
    smax = s.amax(dim=1)
    M = torch.maximum(m_in, smax)
    A = torch.exp(m_in - M)
    P = torch.exp(s - M[:, None])

    dacc_in = gacc * A[:, None]
    dA = (gacc * acc_in).sum(dim=1) + gl * l_in
    dP = gacc @ vf.T + gl[:, None]
    dv = P.T @ gacc
    ds = dP * P
    dM = gm - dA * A - ds.sum(dim=1)
    sel = m_in >= smax
    dm_in = dA * A + torch.where(sel, dM, 0.0)
    eq = (s == smax[:, None]).to(wd)
    onehot = eq / torch.clamp(eq.sum(dim=1, keepdim=True), min=1.0)
    ds = ds + torch.where(sel, 0.0, dM)[:, None] * onehot
    if masked is not None:
        ds = torch.where(masked, 0.0, ds)
    dq = (ds * scale) @ kf
    dk = (ds * scale).T @ qf
    dl_in = gl * A
    return dq, dk, dv, dm_in, dl_in, dacc_in


class _HopUpdate(torch.autograd.Function):
    """The hop update with the hand-derived backward. Forward: K5 when
    ``kernel`` is set, else the plain version."""

    @staticmethod
    def forward(ctx, q, k_c, v_c, m, l, acc, q_off, k_off, scale, causal,
                block_k, kernel):
        if kernel:
            out = flash_hop_update_cuda(q, k_c, v_c, m, l, acc, q_off, k_off,
                                        scale, causal)
        else:
            out = flash_hop_update_reference(q, k_c, v_c, m, l, acc, q_off,
                                             k_off, scale, causal, block_k)
        ctx.save_for_backward(q, k_c, v_c, m, l, acc)
        ctx.hop = (q_off, k_off, scale, causal)
        return out

    @staticmethod
    def backward(ctx, gm, gl, gacc):
        q_off, k_off, scale, causal = ctx.hop
        inputs = ctx.saved_tensors
        grads = _hop_backward(scale, causal, *inputs, q_off, k_off, gm, gl,
                              gacc)
        # Each gradient in its input's type (dq, dk, dv as the JAX
        # backward casts them).
        return tuple(g.to(t.dtype) for g, t in zip(grads, inputs)) \
            + (None,) * 6


def _hop(q, k_c, v_c, m, l, acc, q_off, k_off, scale, causal, block_k,
         kernel: bool):
    return _HopUpdate.apply(q, k_c, v_c, m, l, acc, _offset(q_off),
                            _offset(k_off), float(scale), bool(causal),
                            int(block_k), kernel)


def flash_hop_update(q, k_c, v_c, m, l, acc, q_off: Offset, k_off: Offset,
                     scale: float, causal: bool = False,
                     block_q: int = BLOCK_Q, block_k: int = BLOCK_K):
    """One ring-attention hop: K5 on CUDA tensors, the plain version on CPU
    tensors; differentiable through the hand-derived backward.

    ``q`` ``[sl_q, D]`` is the resident query block; ``k_c``/``v_c``
    ``[sl_k, D]``/``[sl_k, Dv]`` the chunk in flight; ``m``/``l`` ``[sl_q]``
    and ``acc`` ``[sl_q, Dv]`` the float32 carry; ``q_off``/``k_off`` the
    chunks' global row offsets, Python ints or 0-d tensors read once (a
    0-d CUDA tensor costs a synchronisation). Returns the updated
    ``(m, l, acc)``. ``block_q`` and ``block_k`` are there to match the
    JAX function's signature: ``block_q`` is ignored (query tiling changes
    no row's arithmetic), ``block_k`` sets only the plain version's key
    blocks, and on the card K5 ignores both and tiles by its own sizes. An
    operand K5 does not take raises; nothing falls back from the card to
    the plain version.
    """
    if block_q < 1:
        raise ValueError(f"block_q must be positive, got {block_q}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash_hop_update for device {q.device}")
    return _hop(q, k_c, v_c, m, l, acc, q_off, k_off, scale, causal, block_k,
                kernel=q.device.type == "cuda")


def _attention(q, k, v, causal, block_k, kernel):
    s_len, dim = q.shape
    wd = torch.float64 if q.dtype == torch.float64 else torch.float32
    m0 = torch.full((s_len,), _NEG, dtype=wd, device=q.device)
    l0 = torch.zeros((s_len,), dtype=wd, device=q.device)
    acc0 = torch.zeros((s_len, v.shape[1]), dtype=wd, device=q.device)
    m, l, acc = _hop(q, k, v, m0, l0, acc0, 0, 0, 1.0 / math.sqrt(dim),
                     causal, block_k, kernel)
    return (acc / torch.clamp(l, min=1e-30)[:, None]).to(q.dtype)


def flash_attention(q, k, v, causal: bool = False, block_q: int = BLOCK_Q,
                    block_k: int = BLOCK_K):
    """Single-device attention, ``softmax(q k^T / sqrt(D)) v``, as one hop
    over the whole sequence: one K5 launch on CUDA tensors, the plain
    version on CPU tensors. One head, ``[S, D]`` inputs (a head or batch
    axis is not ported yet); returns ``[S, Dv]`` in ``q``'s type.
    ``block_q`` and ``block_k`` match the JAX signature and act as in
    :func:`flash_hop_update`: ignored on the card."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash_attention for device {q.device}")
    if block_q < 1:
        raise ValueError(f"block_q must be positive, got {block_q}")
    return _attention(q, k, v, causal, block_k,
                      kernel=q.device.type == "cuda")


def flash_attention_reference(q, k, v, causal: bool = False,
                              block_k: int = BLOCK_K):
    """:func:`flash_attention` through the plain version of K5 on any
    device, with the same backward: the yardstick K5 is held and timed
    against on the card."""
    return _attention(q, k, v, causal, block_k, kernel=False)
