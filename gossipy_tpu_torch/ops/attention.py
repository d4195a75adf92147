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

K5 is CUDA C++, built at first use, in three routes chosen by the
operands' type and head dims (:func:`route`): bfloat16 q, k, v go to
``csrc/flash_hop_sm90.cu`` (``flash_hop[bf16]``: tensor cores through
``wgmma``, TMA loads, a persistent grid walking the work list of
:func:`hop_schedule`); float32 ones with D and Dv at most
:data:`TF32_MAX_DIM` to ``csrc/flash_hop_tf32.cu`` (``flash_hop[f32]``:
the same machinery with each product as three TF32 products, after the
split pre-pass :func:`tf32_split`, which that source also holds); float32
ones with D or Dv above it, up to :data:`MAX_DIM`, to the same source's
wider instances (``flash_hop[f32-wide]``: the same pre-pass and kernel
on 64-row query tiles). Any other type raises. On CPU
tensors :func:`flash_hop_update` runs the plain version of the kernel,
:func:`flash_hop_update_reference`, which streams over key blocks of
``block_k`` as the TPU kernel does. :func:`flash_hop_update_split_reference`
and :func:`flash_hop_update_tf32_reference` are plain models of the
tensor-core routes' own arithmetic (their work lists and tiles, the split
of their operands, partial carries merged); the CPU tests use them, the
card's path does not. On CUDA tensors K5 launches or raises. Every launch
adds one to ``LAUNCHES["flash_hop"]`` and one to its route's count; the
pre-pass adds one to ``LAUNCHES["tf32_split"]``.

The gradient is the JAX package's hand-derived backward (``_hop_bwd_math``)
in plain PyTorch under :class:`torch.autograd.Function`: it recomputes the
score block from the saved inputs and materialises ``[sl_q, sl_k]``
matrices, as the JAX backward does. No backward kernel launches.
"""

from __future__ import annotations

import ctypes
import heapq
import math
from typing import NamedTuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from ._build import LAUNCHES

# Finite stand-in for -inf: exp() stays NaN-free (as in the JAX package).
_NEG = -1e30
# The TPU kernel's tiles: query rows per program, key rows per streamed
# block. The plain version streams over key blocks of BLOCK_K, so its carry
# is rescaled where the TPU kernel's is; K5 has its own, smaller tiles
# (csrc/), which changes rounding only.
BLOCK_Q = 128
BLOCK_K = 512

KERNEL = "flash_hop"
SPLIT_KERNEL = "tf32_split"
BF16_ROUTE, F32_ROUTE, F32_WIDE_ROUTE = ("flash_hop[bf16]", "flash_hop[f32]",
                                         "flash_hop[f32-wide]")
# The csrc/ source (without .cu) that holds each route's kernel.
SOURCES = {BF16_ROUTE: "flash_hop_sm90", F32_ROUTE: "flash_hop_tf32",
           F32_WIDE_ROUTE: "flash_hop_tf32"}
ROUTES = tuple(SOURCES)
MAX_DIM = 256      # D and Dv up to this, on every route
# float32 heads up to this wide take the 3xTF32 route.
TF32_MAX_DIM = 128
# The bf16 route's tiles (csrc/flash_hop_sm90.cu): 128 query rows per work
# item; key tiles of 128 rows while D and Dv fit two 64-column groups, of 64
# above.
SM90_BLOCK_Q = 128
# The 3xTF32 routes' tiles (csrc/flash_hop_tf32.cu). Up to TF32_MAX_DIM:
# 128 query rows per work item (two warpgroups of 64), 32-key tiles. Wider
# (flash_hop[f32-wide]): 64 query rows, since the hi and lo planes of a
# 128-row tile of 256 columns alone would pass a block's 227 KB of shared
# memory; 32-key tiles up to G = 7 32-column groups, 16-key tiles at G = 8.
TF32_BLOCK_Q = 128
TF32_BLOCK_K = 32
TF32_WIDE_BLOCK_Q = 64
H100_SMS = 132

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


# -- the tensor-core routes' work list and their plain models ----------------

def sm90_tiles(dim: int, dv: int):
    """``(groups, block_k)`` of the bf16 route for head dims ``dim`` and
    ``dv``: the 64-column groups its tiles hold (the wider of the two,
    each rounded up to 8 columns) and its key-tile rows."""
    groups = -(-max(-(-dim // 8) * 8, -(-dv // 8) * 8) // 64)
    return groups, (128 if groups <= 2 else 64)


def tf32_groups(dim: int, dv: int) -> int:
    """The 3xTF32 route's 32-column groups for head dims ``dim`` and
    ``dv`` (its instance): the wider of the two, rounded up to 32."""
    return -(-max(dim, dv) // 32)


def tf32_tiles(dim: int, dv: int):
    """``(block_q, block_k)`` of the 3xTF32 route that takes float32 heads
    ``dim`` and ``dv``: its query rows per work item and key-tile rows."""
    groups = tf32_groups(dim, dv)
    if groups <= TF32_MAX_DIM // 32:
        return TF32_BLOCK_Q, TF32_BLOCK_K
    return TF32_WIDE_BLOCK_Q, (32 if groups < MAX_DIM // 32 else 16)


def route(dtype: torch.dtype, dim: int, dv: int) -> str:
    """K5's route for operands of ``dtype`` and head dims ``dim``, ``dv``
    (up to :data:`MAX_DIM`): bfloat16 → ``flash_hop[bf16]``; float32 with
    both at most :data:`TF32_MAX_DIM` → ``flash_hop[f32]``, wider float32
    → ``flash_hop[f32-wide]`` (both 3xTF32). Raises on any other type."""
    if dtype == torch.bfloat16:
        return BF16_ROUTE
    if dtype == torch.float32:
        return F32_ROUTE if max(dim, dv) <= TF32_MAX_DIM else F32_WIDE_ROUTE
    raise TypeError(f"K5 takes q, k_c and v_c of one type, float32 or "
                    f"bfloat16; got {dtype}")


class HopSchedule(NamedTuple):
    """A tensor-core route's work list. ``items``: ``(q_tile, kt0, kt1,
    slot0, pieces, slot)`` in table order, key tiles ``[kt0, kt1)`` of
    query tile ``q_tile``; a tile cut into ``pieces > 1`` pieces has its
    partial carries in slots ``slot0 ..`` (``slot`` this piece's), else
    both are -1. ``table``: int32, ``n_cta + 1`` offsets into the items
    (CTA ``c`` runs items ``[off[c], off[c + 1])``) then 6 ints per item.
    ``loads``: key tiles per CTA."""
    table: np.ndarray
    items: list
    loads: list
    n_cta: int
    n_slots: int
    n_q_tiles: int


def tiles_needed(sl_q: int, sl_k: int, q_off: int, k_off: int, causal: bool,
                 block_k: int, block_q: int = SM90_BLOCK_Q) -> list:
    """Key tiles each query tile reads: all of them, or when causal those
    holding a key at or before the tile's last query."""
    n_kt = -(-sl_k // block_k)
    need = []
    for q0 in range(0, sl_q, block_q):
        last = q_off + min(q0 + block_q, sl_q) - 1 - k_off
        need.append(n_kt if not causal else
                    0 if last < 0 else min(n_kt, last // block_k + 1))
    return need


def hop_schedule(sl_q: int, sl_k: int, q_off: int, k_off: int, causal: bool,
                 block_k: int = 128, n_sm: int = H100_SMS,
                 block_q: int = SM90_BLOCK_Q) -> HopSchedule:
    """The balanced work list of query tiles of ``block_q`` rows and key
    tiles of ``block_k`` for a card of ``n_sm`` SMs (the bf16 route's tiles
    by default). The key range of each query tile is cut into pieces of
    the mean load per SM (rounded up) and a shorter last one; a query tile
    that needs no key tile gets one empty item, which applies the skipped
    tiles. Items go longest first to the least loaded of
    ``min(n_sm, items)`` CTAs."""
    need = tiles_needed(sl_q, sl_k, q_off, k_off, causal, block_k, block_q)
    cap = max(1, -(-sum(need) // n_sm))
    pieces, n_slots = [], 0
    for qt, n in enumerate(need):
        parts = max(1, -(-n // cap))
        slot0 = n_slots if parts > 1 else -1
        bounds = [min(n, cap * i) for i in range(parts)] + [n]
        for i in range(parts):
            pieces.append((qt, bounds[i], bounds[i + 1], slot0, parts,
                           slot0 + i if parts > 1 else -1))
        if parts > 1:
            n_slots += parts
    pieces.sort(key=lambda it: (it[1] - it[2], it[0], it[1]))
    n_cta = min(n_sm, len(pieces))
    heap = [(0.0, c) for c in range(n_cta)]
    per_cta = [[] for _ in range(n_cta)]
    loads = [0] * n_cta
    for it in pieces:
        load, c = heapq.heappop(heap)
        per_cta[c].append(it)
        loads[c] += it[2] - it[1]
        # An empty item costs its epilogue: a little, so they spread.
        heapq.heappush(heap, (load + max(it[2] - it[1], 0.25), c))
    items = [it for cta in per_cta for it in cta]
    offs = np.cumsum([0] + [len(cta) for cta in per_cta])
    table = np.concatenate([offs, np.asarray(items, np.int64).ravel()])
    return HopSchedule(table.astype(np.int32), items, loads, n_cta, n_slots,
                       len(need))


def _scheduled_hop(q, k_c, v_c, m, l, acc, q_off, k_off, scale, causal,
                   n_sm, block_q, block_k, scores, p_times_v):
    """The tensor-core routes' arithmetic with the products left to the
    caller: walk the work list of :func:`hop_schedule`, stream each piece's
    key tiles into a partial carry started at ``m = _NEG``, ``l = 0``,
    ``acc = 0`` (``s = scores(q rows, k rows) * scale``, ``acc += p_times_v(p,
    v rows)``), and merge the incoming carry, the pieces in slot order and,
    where key tiles were skipped, a ``(_NEG, 0, 0)`` term:
    ``m = max m_i``, ``l = sum l_i exp(m_i - m)``, ``acc`` likewise. A
    ragged last tile counts its padded keys as masked (``_NEG`` in the row
    max). Float32; returns ``(m, l, acc)``."""
    _check_hop(q, k_c, v_c, m, l, acc)
    q_off, k_off = _offset(q_off), _offset(k_off)
    sl_q, sl_k = q.shape[0], k_c.shape[0]
    dv = v_c.shape[1]
    sched = hop_schedule(sl_q, sl_k, q_off, k_off, causal, block_k, n_sm,
                         block_q)
    qf, kf, vf = (t.float() for t in (q, k_c, v_c))
    m, l, acc = (t.float() for t in (m, l, acc))
    n_kt = -(-sl_k // block_k)
    parts, need = {}, {}
    for qt, kt0, kt1, _, _, slot in sched.items:
        r0, r1 = qt * block_q, min((qt + 1) * block_q, sl_q)
        pm = torch.full((r1 - r0,), _NEG, device=q.device)
        pl = torch.zeros(r1 - r0, device=q.device)
        pa = torch.zeros(r1 - r0, dv, device=q.device)
        for kt in range(kt0, kt1):
            c0, c1 = kt * block_k, min((kt + 1) * block_k, sl_k)
            s = scores(qf[r0:r1], kf[c0:c1]) * scale
            masked = torch.zeros_like(s, dtype=torch.bool)
            if causal:
                masked = _causal_mask(r1 - r0, c1 - c0, q_off + r0,
                                      k_off + c0, q.device)
                s = torch.where(masked, _NEG, s)
            mx = s.amax(dim=1)
            if c1 - c0 < block_k:
                mx = torch.clamp(mx, min=_NEG)
            m_new = torch.maximum(pm, mx)
            alpha = torch.exp(pm - m_new)
            p = torch.where(masked, 0.0, torch.exp(s - m_new[:, None]))
            pa = pa * alpha[:, None] + p_times_v(p, vf[c0:c1])
            pl = pl * alpha + p.sum(dim=1)
            pm = m_new
        parts.setdefault(qt, []).append((slot, pm, pl, pa))
        need[qt] = max(need.get(qt, 0), kt1)
    m_out, l_out, acc_out = m.clone(), l.clone(), acc.clone()
    for qt, terms in parts.items():
        r0, r1 = qt * block_q, min((qt + 1) * block_q, sl_q)
        m0 = m[r0:r1]
        top = m0 if need[qt] == n_kt else torch.clamp(m0, min=_NEG)
        for _, pm, _, _ in terms:
            top = torch.maximum(top, pm)
        e0 = torch.exp(m0 - top)
        l_new, a_new = l[r0:r1] * e0, acc[r0:r1] * e0[:, None]
        for _, pm, pl, pa in sorted(terms, key=lambda t: t[0]):
            w = torch.exp(pm - top)
            l_new = l_new + pl * w
            a_new = a_new + pa * w[:, None]
        m_out[r0:r1], l_out[r0:r1], acc_out[r0:r1] = top, l_new, a_new
    return m_out, l_out, acc_out


def flash_hop_update_split_reference(q, k_c, v_c, m, l, acc, q_off: Offset,
                                     k_off: Offset, scale: float,
                                     causal: bool = False,
                                     n_sm: int = H100_SMS):
    """Plain PyTorch model of the bf16 route's arithmetic: its work list
    and tiles (128 query rows, :func:`sm90_tiles`' key tiles), ``q k^T`` of
    the bf16 operands (exact in float32) and ``p`` split into a bf16 high
    part and a bf16 low part for the ``p v`` product. Float32; returns
    ``(m, l, acc)``."""
    _, bk = sm90_tiles(q.shape[1], v_c.shape[1])

    def p_times_v(p, v):
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        return hi @ v + lo @ v

    return _scheduled_hop(q, k_c, v_c, m, l, acc, q_off, k_off, scale,
                          causal, n_sm, SM90_BLOCK_Q, bk,
                          lambda a, b: a @ b.T, p_times_v)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` does: to
    nearest, ties away from zero, by adding half a TF32 step to the
    magnitude's bits and clearing the low 13. Non-finite values pass
    through."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def tf32_parts(x: torch.Tensor):
    """``(hi, lo)``: ``hi = tf32_round(x)``, ``lo = tf32_round(x - hi)``
    (``x - hi`` is exact in float32)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def _tf32x3(a_parts, b_parts):
    """``a b`` as the 3xTF32 route computes it: the small products, then
    the large one, from ``(hi, lo)`` parts (``lo`` None: one TF32
    product)."""
    (a_hi, a_lo), (b_hi, b_lo) = a_parts, b_parts
    if a_lo is None:
        return a_hi @ b_hi
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def flash_hop_update_tf32_reference(q, k_c, v_c, m, l, acc, q_off: Offset,
                                    k_off: Offset, scale: float,
                                    causal: bool = False,
                                    n_sm: int = H100_SMS,
                                    low_parts: bool = True):
    """Plain PyTorch model of the 3xTF32 routes' arithmetic, for float32
    operands: the work list and tiles of the route that takes these head
    dims (:func:`tf32_tiles`: ``flash_hop[f32]`` or
    ``flash_hop[f32-wide]``), and both products as
    ``lo_a hi_b + hi_a lo_b + hi_a hi_b`` of TF32 parts
    (:func:`tf32_parts`), ``q k^T`` from the split operands and ``p v``
    with ``p`` split in the same way. ``low_parts=False`` drops the low
    parts: one plain TF32 product each. Float32; returns ``(m, l, acc)``."""
    def parts(x):
        return tf32_parts(x) if low_parts else (tf32_round(x), None)

    block_q, block_k = tf32_tiles(q.shape[1], v_c.shape[1])
    return _scheduled_hop(
        q, k_c, v_c, m, l, acc, q_off, k_off, scale, causal, n_sm,
        block_q, block_k,
        lambda a, b: _tf32x3(parts(a), parts(b.T.contiguous())),
        lambda p, v: _tf32x3(parts(p), parts(v)))


def tf32_split_reference(q, k_c, v_c):
    """Plain version of the 3xTF32 route's pre-pass: ``(qs, ks, vt)``,
    float32 planes ``[2, rows, 32 G]`` of q's and k's hi and lo parts
    (zero columns past D), and ``[2, 32 G, ld_k]`` of v's transposed, with
    G = :func:`tf32_groups`, ``ld_k`` = ``sl_k`` rounded up to 8, zeros past
    Dv and ``sl_k``, and the keys of each 8-key group in the order
    (0, 2, 4, 6, 1, 3, 5, 7): the A fragment of a TF32 ``wgmma`` holds
    keys t and t + 4 of a k-step where the score accumulator holds 2t and
    2t + 1."""
    (sl_k, dv), dim = v_c.shape, q.shape[1]
    cols = 32 * tf32_groups(dim, dv)
    ld_k = -(-sl_k // 8) * 8
    qf, kf, vf = (t.float() for t in (q, k_c, v_c))
    qs = torch.stack(tf32_parts(F.pad(qf, (0, cols - dim))))
    ks = torch.stack(tf32_parts(F.pad(kf, (0, cols - dim))))
    vt = F.pad(vf, (0, cols - dv, 0, ld_k - sl_k)).T
    # The order by arithmetic, on v's device (no host copy: this runs
    # inside CUDA graph captures when timed): position t of a group holds
    # key 2t for t < 4, else 2t - 7.
    pos = torch.arange(ld_k, device=vt.device)
    t = pos % 8
    order = pos - t + torch.where(t < 4, 2 * t, 2 * t - 7)
    vt = torch.stack(tf32_parts(vt[:, order].contiguous()))
    return qs, ks, vt


def tf32_split(q, k_c, v_c):
    """The 3xTF32 route's pre-pass: its kernel on CUDA tensors (one launch,
    counted in ``LAUNCHES["tf32_split"]``), :func:`tf32_split_reference`
    on CPU tensors."""
    if q.device.type == "cpu":
        return tf32_split_reference(q, k_c, v_c)
    if not q.is_cuda:
        raise ValueError(f"no tf32_split for device {q.device}")
    if any(t.dtype != torch.float32 for t in (q, k_c, v_c)):
        raise TypeError("tf32_split takes float32 q, k_c and v_c")
    if q.dim() != 2 or v_c.dim() != 2 or k_c.shape != (v_c.shape[0],
                                                        q.shape[1]):
        raise ValueError(f"tf32_split takes q [rows, D], k_c [keys, D] and "
                         f"v_c [keys, Dv]; got {tuple(q.shape)}, "
                         f"{tuple(k_c.shape)}, {tuple(v_c.shape)}")
    (sl_q, dim), (sl_k, dv) = q.shape, v_c.shape
    groups = tf32_groups(dim, dv)
    if groups > MAX_DIM // 32:
        raise ValueError(f"tf32_split takes D and Dv up to {MAX_DIM}, got "
                         f"{dim} and {dv}")
    q, k_c, v_c = (t.contiguous() for t in (q, k_c, v_c))
    ld_k = -(-sl_k // 8) * 8
    qs = torch.empty(2, sl_q, 32 * groups, device=q.device)
    ks = torch.empty(2, sl_k, 32 * groups, device=q.device)
    vt = torch.empty(2, 32 * groups, ld_k, device=q.device)
    fn = _build.function(SOURCES[F32_ROUTE], "tf32_split",
                         [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 6
                         + [ctypes.c_void_p])
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_c.data_ptr(), v_c.data_ptr(), qs.data_ptr(),
                ks.data_ptr(), vt.data_ptr(), sl_q, sl_k, dim, dv, groups,
                ld_k, _build.stream(q))
    _build.raise_if_failed(SPLIT_KERNEL, rc)
    LAUNCHES[SPLIT_KERNEL] += 1
    return qs, ks, vt


# -- K5 -----------------------------------------------------------------------

def flash_hop_update_cuda(q, k_c, v_c, m, l, acc, q_off: Offset,
                          k_off: Offset, scale: float, causal: bool = False):
    """Launch K5; returns new float32 tensors ``(m, l, acc)``.

    ``q``, ``k_c``, ``v_c`` are one type, and :func:`route` picks the route
    by type and head dims: bfloat16 runs ``csrc/flash_hop_sm90.cu``,
    float32 one of the 3xTF32 routes (the pre-pass :func:`tf32_split`,
    then the hop of ``csrc/flash_hop_tf32.cu``, on 128-row query tiles
    with D and Dv at most :data:`TF32_MAX_DIM`, on 64-row ones above); the
    carry is float32. ``D`` and ``Dv`` are at most :data:`MAX_DIM`. Raises
    on an operand K5 does not take and when a launch reports an error."""
    _check_hop(q, k_c, v_c, m, l, acc)
    if k_c.dtype != q.dtype or v_c.dtype != q.dtype:
        raise TypeError(f"K5 takes q, k_c and v_c of one type; got "
                        f"{q.dtype}, {k_c.dtype}, {v_c.dtype}")
    if any(t.dtype != torch.float32 for t in (m, l, acc)):
        raise TypeError("K5 takes a float32 carry (m, l, acc)")
    dim, dv = q.shape[1], v_c.shape[1]
    name = route(q.dtype, dim, dv)
    if dim > MAX_DIM or dv > MAX_DIM:
        raise ValueError(f"K5 takes D and Dv up to {MAX_DIM}, got {dim} and "
                         f"{dv}")
    if not q.is_cuda:
        raise ValueError("flash_hop_update_cuda takes CUDA tensors")
    q_off, k_off = _offset(q_off), _offset(k_off)
    m, l, acc = (t.contiguous() for t in (m, l, acc))
    m_out, l_out, acc_out = (torch.empty_like(t) for t in (m, l, acc))
    launch = _launch_sm90 if name == BF16_ROUTE else _launch_tf32
    with torch.cuda.device(q.device):
        rc = launch(q, k_c, v_c, m, l, acc, m_out, l_out, acc_out, q_off,
                    k_off, float(scale), int(bool(causal)))
    _build.raise_if_failed(name, rc)
    LAUNCHES[KERNEL] += 1
    LAUNCHES[name] += 1
    return m_out, l_out, acc_out


def _tma_operand(t: torch.Tensor, cols: int) -> torch.Tensor:
    """``t`` as TMA reads it: contiguous, ``cols`` columns (a copy padded
    with zero columns when its width is not a multiple of 8, so that rows
    start on 16 bytes) and a 16-byte-aligned base (a copy if not)."""
    t = t.contiguous()
    if t.shape[1] != cols:
        t = F.pad(t, (0, cols - t.shape[1]))
    if t.data_ptr() % 16:
        t = t.clone()
    return t


# Work lists on the card, by (device, shape, offsets, causal, tiles, SMs).
# A launch being captured in a CUDA graph reads the list cached by an
# earlier call of the same hop; building one needs a host-to-device copy,
# which a capture cannot hold. A graph keeps the table's address, so no
# entry is ever dropped: the cache holds one table of a few KB for each
# distinct hop a process runs.
_SCHEDULES: dict = {}


def _cached_schedule(dev, n_sm, sl_q, sl_k, q_off, k_off, causal, bk, bq,
                     capturing: bool = False):
    """``(table on dev, HopSchedule)`` of this hop, built and cached at
    first use and the same objects ever after; raises while ``capturing``
    a CUDA graph if the list is not cached yet."""
    key = (dev, sl_q, sl_k, q_off, k_off, bool(causal), bq, bk, n_sm)
    hit = _SCHEDULES.get(key)
    if hit is None:
        if capturing:
            raise RuntimeError("K5's work list for this hop is not on the card "
                               "yet: call the hop once before capturing it")
        sched = hop_schedule(sl_q, sl_k, q_off, k_off, causal, bk, n_sm, bq)
        hit = (torch.from_numpy(sched.table).to(dev), sched)
        _SCHEDULES[key] = hit
    return hit


def _device_schedule(dev, sl_q, sl_k, q_off, k_off, causal, bk,
                     bq=SM90_BLOCK_Q):
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    return _cached_schedule(dev, n_sm, sl_q, sl_k, q_off, k_off, causal, bk,
                            bq, torch.cuda.is_current_stream_capturing())


def _workspace(sched, block_q, acc_cols, dev):
    """The partial carries (``n_slots`` x ``block_q`` x (2 + ``acc_cols``)
    float32) and the tickets (one int32 per query tile, zeroed) of split
    query tiles. Freed when the launch returns: the caching allocator
    hands the blocks only to work queued after the kernel on the same
    stream."""
    part = torch.empty(max(1, sched.n_slots * block_q * (2 + acc_cols)),
                       dtype=torch.float32, device=dev)
    tickets = (torch.zeros(sched.n_q_tiles, dtype=torch.int32, device=dev)
               if sched.n_slots else torch.empty(1, dtype=torch.int32,
                                                  device=dev))
    return part, tickets


def _launch_sm90(q, k_c, v_c, m, l, acc, m_out, l_out, acc_out, q_off, k_off,
                 scale, causal) -> int:
    (sl_q, dim), (sl_k, dv) = q.shape, v_c.shape
    groups, bk = sm90_tiles(dim, dv)
    ld_qk, ld_v = -(-dim // 8) * 8, -(-dv // 8) * 8
    q, k_c = (_tma_operand(t, ld_qk) for t in (q, k_c))
    v_c = _tma_operand(v_c, ld_v)
    table, sched = _device_schedule(q.device, sl_q, sl_k, q_off, k_off,
                                    causal, bk)
    part, tickets = _workspace(sched, SM90_BLOCK_Q, 64 * groups, q.device)
    fn = _build.function(SOURCES[BF16_ROUTE], "flash_hop_sm90",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3
                         + [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 4
                         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_int, ctypes.c_void_p])
    return fn(q.data_ptr(), k_c.data_ptr(), v_c.data_ptr(), ld_qk, ld_v, dv,
              m.data_ptr(), l.data_ptr(), acc.data_ptr(), m_out.data_ptr(),
              l_out.data_ptr(), acc_out.data_ptr(), sl_q, sl_k, q_off, k_off,
              scale, causal, table.data_ptr(), sched.n_cta, part.data_ptr(),
              tickets.data_ptr(), bk, _build.stream(q))


def _launch_tf32(q, k_c, v_c, m, l, acc, m_out, l_out, acc_out, q_off, k_off,
                 scale, causal) -> int:
    """Both 3xTF32 routes: the pre-pass, then the hop on the work list
    of the route's tiles."""
    (sl_q, dim), (sl_k, dv) = q.shape, v_c.shape
    groups = tf32_groups(dim, dv)
    bq, bk = tf32_tiles(dim, dv)
    qs, ks, vt = tf32_split(q, k_c, v_c)
    table, sched = _device_schedule(q.device, sl_q, sl_k, q_off, k_off,
                                    causal, bk, bq)
    part, tickets = _workspace(sched, bq, 32 * groups, q.device)
    fn = _build.function(SOURCES[F32_ROUTE], "flash_hop_tf32",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3
                         + [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 4
                         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return fn(qs.data_ptr(), ks.data_ptr(), vt.data_ptr(), groups,
              vt.shape[2], dv, m.data_ptr(), l.data_ptr(), acc.data_ptr(),
              m_out.data_ptr(), l_out.data_ptr(), acc_out.data_ptr(), sl_q,
              sl_k, q_off, k_off, scale, causal, table.data_ptr(),
              sched.n_cta, part.data_ptr(), tickets.data_ptr(), bq, bk,
              _build.stream(q))


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
