"""Gather-merge: blend peer snapshots from the history ring into receivers.

Counterpart of ``gossipy_tpu/ops/merge.py``. ``h`` is the flat
``[D*N, F]`` snapshot ring, in float32 or in a wire format (bfloat16, or
int8 with a float32 scale per (ring row, leaf)); a peer row is widened to
float32, times its scale, before it is blended:

- single slot (:func:`gather_merge_flat`, the ``fused_merge="per_slot"``
  path):
  ``out[i] = w_self[i] * p[i] + w_peer[i] * peer(idx[i])``, with no
  zero-weight mask, as the JAX kernel;
- multi slot (:func:`gather_merge_multi`, the single-pass deliver): for
  every receiver row the K slots of its mailbox cell fold left to right,
  ``out = p[i]``; for each slot ``k``:
  ``out = w_self[i, k] * out + (w_peer[i, k] != 0 ? w_peer[i, k] * peer(idx[i, k]) : 0)``.
  Empty slots carry ``(w_self, w_peer) = (1, 0)``; the ring row (and scale)
  behind their index is never used, even when it is not finite.

Scales. ``scale`` is ``[M]`` (one per ring row) or ``[M, L]`` (one per
ring row and leaf, the port's int8 sidecar); ``leaf_starts`` gives the
``L`` leaves' start columns (``leaf_starts[0] == 0``, increasing). A
column belongs to the last leaf that starts at or before it, so padding
columns past the last leaf take its scale. The kernels read the scales of
the rows they name straight from the ``[M, L]`` table; the JAX package
gathers them outside its kernels (merge.py:155-156, 366-368).

Four kernels in two CUDA C++ sources in ``csrc/``, built at first use:

=====  ==========================  ======================  ======================
id     replaces (JAX merge.py)     launched for            source
=====  ==========================  ======================  ======================
K1     ``_multi_kernel``           multi, float32 ring     ``gather_merge_multi.cu``
K2     ``_multi_dq_kernel``        multi, wire format      ``gather_merge_multi.cu``
K3     ``_kernel``                 single, float32 ring    ``gather_merge_flat.cu``
K4     ``_dq_kernel``              single, wire format     ``gather_merge_flat.cu``
=====  ==========================  ======================  ======================

"Wire format" means a bfloat16 ring, or any ring with a scale (an int8
ring always has one). Every kernel reads the index table as the engine
makes it, int64 (``[N, K]`` for K1/K2, ``[N]`` for K3/K4; any other type
raises on the card), so a call is one launch. :func:`launch_plan` maps
K1/K2's rows onto the card and :func:`flat_plan` K3/K4's: a group of
lanes a row for rows of up to 32 words, a block per row tile for wider
ones. Each
public function runs the plain PyTorch version (``*_reference``) on CPU
tensors, and on CUDA tensors launches its kernel or raises: it never falls
back from the card to the plain version. Every launch adds one to
``LAUNCHES[<kernel>]``; every call of :func:`gather_merge_multi` and
:func:`gather_merge_flat`, on either route, one to
``_build.ENTRIES[<kernel>]`` (the kernel-entry log).

The ``*_pytree`` forms take per-leaf dicts, as the JAX package's pytree
forms do, and make one launch over their concatenation (the JAX package's
single-slot pytree form launches once per leaf; one launch over the
concatenated row computes the same thing). The engine does not need them:
it keeps each node's parameters in one flat row already.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Sequence, Union

import torch

from . import _build
from ._build import LAUNCHES, reset_launch_counts

KERNEL = "gather_merge_multi"             # K1
KERNEL_MULTI_DQ = "gather_merge_multi_dq"  # K2
KERNEL_FLAT = "gather_merge_flat"         # K3
KERNEL_FLAT_DQ = "gather_merge_flat_dq"   # K4
# The csrc/ source (without .cu) that holds each kernel's entry point.
SOURCES = {KERNEL: "gather_merge_multi",
           KERNEL_MULTI_DQ: "gather_merge_multi",
           KERNEL_FLAT: "gather_merge_flat",
           KERNEL_FLAT_DQ: "gather_merge_flat"}
MAX_SLOTS = 64     # kMaxSlots in the CUDA sources
MAX_LEAVES = 256   # wire::kMaxLeaves
MAX_SCALES = 8192  # K x L scales K2 stages for one row on the wide route
# K1/K2's launch limits (kWarp, kMaxThreads, kTableRegs in
# gather_merge_multi.cu), and the grid's.
WARP = 32
BLOCK = 256
TABLE_REGS = 2     # a lane holds 2 slots of its row's tables: K <= 2 group
WIDE_WORDS = 2     # words a lane takes on the wide route: K1/K2's for
                   # K <= 8, K3/K4's always (kWideWords in
                   # gather_merge_flat.cu)
MAX_RING_ROWS = 2**31 - 1  # the kernels keep a ring row index in 32 bits
MAX_GRID_X = 2**31 - 1
MAX_GRID_Y = 65535
SMS = 132          # the H100 SXM's multiprocessors: fewer rows are "few"
# Ring storage types and their codes in the CUDA sources (wire_rows.cuh).
WIRE_FORMATS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

LeafStarts = Union[Sequence[int], torch.Tensor, None]

# -- scales and leaves -------------------------------------------------------

def _scale_table(scale: Optional[torch.Tensor], leaf_starts: LeafStarts,
                 m: int, f: int):
    """``scale`` as ``[M, L]`` and the leaf starts as a list or tensor
    (``None`` when there is no scale). Raises on a table that does not fit
    the ring."""
    if scale is None:
        if leaf_starts is not None:
            raise ValueError("leaf_starts without a scale")
        return None, None
    if scale.dim() == 1:
        scale = scale[:, None]
    if scale.dim() != 2 or scale.shape[0] != m:
        raise ValueError(f"scale must be [M] or [M, L] with M = {m}, got "
                         f"{tuple(scale.shape)}")
    n_leaves = scale.shape[1]
    if leaf_starts is None:
        if n_leaves != 1:
            raise ValueError("a scale with several leaves needs leaf_starts")
        leaf_starts = [0]
    if isinstance(leaf_starts, torch.Tensor):
        if leaf_starts.dim() != 1 or leaf_starts.shape[0] != n_leaves:
            raise ValueError("leaf_starts must be [L] like scale's columns")
    else:
        leaf_starts = [int(s) for s in leaf_starts]
        if len(leaf_starts) != n_leaves or leaf_starts[0] != 0 or any(
                b <= a for a, b in zip(leaf_starts, leaf_starts[1:])) \
                or leaf_starts[-1] >= f:
            raise ValueError(f"leaf_starts {leaf_starts} must be L = "
                             f"{n_leaves} increasing columns from 0 below "
                             f"F = {f}")
    return scale, leaf_starts


def column_leaves(leaf_starts: LeafStarts, f: int,
                  device) -> torch.Tensor:
    """The leaf index of each of ``f`` columns: the last leaf starting at
    or before it."""
    starts = torch.as_tensor(leaf_starts, dtype=torch.int64, device=device)
    cols = torch.arange(f, device=device)
    return torch.bucketize(cols, starts, right=True) - 1


def _widen(rows: torch.Tensor, dtype, scale_g: Optional[torch.Tensor],
           leaf_starts: LeafStarts) -> torch.Tensor:
    """Ring rows ``[R, F]`` widened to ``dtype``, times their ``[R, L]``
    scales by column leaf."""
    peer = rows.to(dtype)
    if scale_g is not None:
        cols = column_leaves(leaf_starts, peer.shape[1], peer.device)
        peer = peer * scale_g.to(dtype)[:, cols]
    return peer


def _starts_on(leaf_starts: LeafStarts, device) -> torch.Tensor:
    return torch.as_tensor(leaf_starts, dtype=torch.int32,
                           device=device).contiguous()


def _check_devices(*tensors) -> None:
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"all operands must be on one device, got {devices}")


def _check_kernel_operands(caller: str, p: torch.Tensor, h: torch.Tensor):
    if not p.is_cuda:
        raise ValueError(f"{caller} takes CUDA tensors")
    if p.dtype != torch.float32:
        raise TypeError("the kernels merge into float32 params")
    if h.dtype not in WIRE_FORMATS:
        raise TypeError(f"ring dtype {h.dtype} is not a wire format "
                        f"({sorted(str(d) for d in WIRE_FORMATS)})")
    if not (p.is_contiguous() and h.is_contiguous()):
        raise ValueError("p and h must be contiguous")


def _check_wire_scale(caller: str, h: torch.Tensor, scale) -> None:
    """The dequantizing kernels (K2, K4) take a bfloat16 ring with no scale
    or any ring with one; a float32 ring with none is K1's or K3's."""
    if scale is None and h.dtype != torch.bfloat16:
        raise TypeError(f"{caller}: a {h.dtype} ring needs a scale")


# -- multi slot: K1 and K2 ---------------------------------------------------

class MultiPlan(NamedTuple):
    """How K1/K2 map an ``[N, F]`` call onto the card.

    A row is ``words`` words: 4 columns each in the vector form (``vec``:
    F a multiple of 4 and the operands aligned), 1 in the scalar form. On
    the narrow route a group of ``group`` lanes (a power of two up to a
    warp) takes a row, one word a lane, and a block of ``threads`` lanes
    holds ``rows_per_block`` rows; the grid is ``(ceil(N / rows), 1)``.
    On the wide route (``wide``: more than 32 words) a block of 256 lanes
    takes a tile of ``256 * words_per_lane`` words of one row, each warp a
    group; the grid is ``(N, tiles)``. Lane ``s % group`` of a group holds
    slots ``s`` and ``s + group`` of the row's tables, so ``K <= 2
    group``. ``in_flight``: the events (live slots, or empty ones whose
    w_self is not 1) whose peer words a lane loads before it folds them.
    For K > 8, 8 events and one word a lane on either route; for K <= 8,
    4 and one on the narrow route, 2 and two on the wide one.

    ``slots`` (``in_flight`` 1): the slot walk, a block per row tile of
    ``threads`` words, one word a lane, the tables in shared memory and
    every slot (K > 8) or the events (K <= 8) folded one at a time. It
    takes the wide route with a scale table, and calls of fewer than
    ``SMS`` rows with K > 8, which leave most of the card idle and where a
    table with many live slots costs the event walk a pass per
    ``in_flight`` events."""
    vec: bool
    wide: bool
    group: int
    threads: int
    grid: tuple
    words: int
    rows_per_block: int
    words_per_lane: int
    in_flight: int

    @property
    def slots(self) -> bool:
        return self.in_flight == 1

    def as_args(self):
        """The eight int64 values the C entry points take."""
        return (ctypes.c_int64 * 8)(int(self.vec), int(self.wide), self.group,
                                    self.threads, *self.grid,
                                    self.words_per_lane, self.in_flight)


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def _narrow_layout(n: int, group: int):
    """The narrow route's rows a block, lanes a block and grid for ``n``
    rows of ``group`` lanes each (K1-K4)."""
    rows = BLOCK // group
    return rows, BLOCK, (-(-n // rows), 1)


def _check_grid(n: int, f: int, grid: tuple) -> None:
    if grid[0] > MAX_GRID_X or grid[1] > MAX_GRID_Y:
        raise ValueError(f"[{n}, {f}] needs grid {grid}, past the card's "
                         f"({MAX_GRID_X}, {MAX_GRID_Y})")


def _aligned(p: torch.Tensor, h: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether the operands take the vector form: p and out aligned to 16
    bytes, ring rows to 4 values."""
    return (p.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
            and h.data_ptr() % (4 * h.element_size()) == 0)


@functools.lru_cache(maxsize=1024)
def launch_plan(n: int, f: int, k: int, ring_dtype=torch.float32,
                aligned: bool = True, scaled: bool = False) -> MultiPlan:
    """K1/K2's :class:`MultiPlan` for ``n`` rows of ``f`` columns, ``k``
    slots, a ring of ``ring_dtype`` (``scaled``: with a scale table, as an
    int8 ring always is) and operands ``aligned`` for the vector form (p
    and out to 16 bytes, ring rows to 4 values). Raises where the kernel
    cannot run the call: too many slots, or a grid past the card's
    limits."""
    if ring_dtype not in WIRE_FORMATS:
        raise TypeError(f"ring dtype {ring_dtype} is not a wire format")
    if not 1 <= k <= MAX_SLOTS:
        raise ValueError(f"1 to {MAX_SLOTS} slots, got {k}")
    if n < 1 or f < 1:
        raise ValueError(f"no rows or columns: [{n}, {f}]")
    scaled = scaled or ring_dtype == torch.int8
    vec = aligned and f % 4 == 0
    words = f // 4 if vec else f
    wide = words > WARP
    slots = (wide and scaled) or (k > 8 and n < SMS)
    if wide or slots:
        group, rows = WARP, 1
        in_flight, per_lane = ((1, 1) if slots else (8, 1) if k > 8
                               else (2, WIDE_WORDS))
        # A narrow row's slot walk takes a warp, or 256 lanes to stage
        # its K x L scales.
        threads = BLOCK if wide or scaled else WARP
        grid = (n, -(-words // (threads * per_lane)))
    else:
        # Enough lanes for the row's words and for its slots.
        group = max(_pow2_at_least(words),
                    _pow2_at_least(-(-k // TABLE_REGS)))
        rows, threads, grid = _narrow_layout(n, group)
        per_lane, in_flight = 1, 4 if k <= 8 else 8
    _check_grid(n, f, grid)
    return MultiPlan(vec, wide, group, threads, grid, words, rows, per_lane,
                     in_flight)


@functools.lru_cache(maxsize=1024)
def _plan_args(n: int, f: int, k: int, ring_dtype, aligned: bool,
               scaled: bool):
    return launch_plan(n, f, k, ring_dtype, aligned, scaled).as_args()


def _plan_for(p: torch.Tensor, h: torch.Tensor, out: torch.Tensor, k: int,
              scaled: bool):
    """The plan's eight values for this call, as the C entry points take
    them."""
    if h.shape[0] > MAX_RING_ROWS:
        raise ValueError(f"at most {MAX_RING_ROWS} ring rows, got "
                         f"{h.shape[0]}")
    return _plan_args(p.shape[0], p.shape[1], k, h.dtype,
                      _aligned(p, h, out), scaled)


def _index_table(idx: torch.Tensor) -> torch.Tensor:
    """The index table as the kernels read it: int64, never cast (a cast
    would be a second kernel a call)."""
    if idx.dtype != torch.int64:
        raise TypeError(f"idx must be int64, got {idx.dtype}")
    return idx.contiguous()


def gather_merge_multi_reference(p: torch.Tensor, h: torch.Tensor,
                                 idx: torch.Tensor, w_self: torch.Tensor,
                                 w_peer: torch.Tensor,
                                 scale: Optional[torch.Tensor] = None,
                                 leaf_starts: LeafStarts = None
                                 ) -> torch.Tensor:
    """Plain PyTorch version of K1/K2: the same fold, one slot at a time,
    with the peer rows gathered and widened (``p [N, F]``, ``h [M, F]``,
    tables ``[N, K]``)."""
    scale, leaf_starts = _scale_table(scale, leaf_starts, h.shape[0],
                                      p.shape[1])
    out = p
    for k in range(idx.shape[1]):
        rows = idx[:, k].long()
        peer = _widen(h[rows], p.dtype,
                      None if scale is None else scale[rows], leaf_starts)
        wp = w_peer[:, k].to(p.dtype)[:, None]
        contrib = torch.where(wp != 0, wp * peer, torch.zeros_like(peer))
        out = w_self[:, k].to(p.dtype)[:, None] * out + contrib
    return out


def _check_multi(p, h, idx, w_self, w_peer):
    if idx.dim() != 2:
        raise ValueError(f"idx must be [N, K], got shape {tuple(idx.shape)}")
    n, k = idx.shape
    if p.dim() != 2 or h.dim() != 2 or p.shape[0] != n \
            or h.shape[1] != p.shape[1]:
        raise ValueError(f"shapes do not fit: p {tuple(p.shape)}, "
                         f"h {tuple(h.shape)}, idx {tuple(idx.shape)}")
    if tuple(w_self.shape) != (n, k) or tuple(w_peer.shape) != (n, k):
        raise ValueError("w_self and w_peer must be [N, K] like idx")
    _check_devices(p, h, idx, w_self, w_peer)


def gather_merge_multi_cuda(p: torch.Tensor, h: torch.Tensor,
                            idx: torch.Tensor, w_self: torch.Tensor,
                            w_peer: torch.Tensor) -> torch.Tensor:
    """Launch K1 (float32 ring); returns a new ``[N, F]`` tensor.

    Live indices must lie in ``[0, M)``. Raises on an operand the kernel
    does not take and when the launch reports an error.
    """
    _check_multi(p, h, idx, w_self, w_peer)
    _check_kernel_operands("gather_merge_multi_cuda", p, h)
    if h.dtype != torch.float32:
        raise TypeError("K1 merges a float32 ring; gather_merge_multi_dq_cuda "
                        "takes the wire formats")
    n, k = idx.shape
    f = p.shape[1]
    tab = _index_table(idx)
    ws = w_self.to(torch.float32).contiguous()
    wp = w_peer.to(torch.float32).contiguous()
    out = torch.empty_like(p)
    plan = _plan_for(p, h, out, k, False)
    fn = _build.function(SOURCES[KERNEL], "gather_merge_multi",
                         [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3
                         + [ctypes.c_void_p] * 2)
    with torch.cuda.device(p.device):
        rc = fn(p.data_ptr(), h.data_ptr(), tab.data_ptr(), ws.data_ptr(),
                wp.data_ptr(), out.data_ptr(), n, f, k, plan,
                _build.stream(p))
    _build.raise_if_failed(KERNEL, rc)
    LAUNCHES[KERNEL] += 1
    return out


def gather_merge_multi_dq_cuda(p: torch.Tensor, h: torch.Tensor,
                               idx: torch.Tensor, w_self: torch.Tensor,
                               w_peer: torch.Tensor,
                               scale: Optional[torch.Tensor] = None,
                               leaf_starts: LeafStarts = None
                               ) -> torch.Tensor:
    """Launch K2 (a bfloat16 ring, or any ring with a scale); returns a new
    ``[N, F]`` tensor. The kernel reads the scales of the rows live slots
    name from the ``[M, L]`` table."""
    _check_multi(p, h, idx, w_self, w_peer)
    _check_kernel_operands("gather_merge_multi_dq_cuda", p, h)
    _check_wire_scale("gather_merge_multi_dq_cuda", h, scale)
    scale, leaf_starts = _scale_table(scale, leaf_starts, h.shape[0],
                                      p.shape[1])
    _check_devices(p, scale)
    n, k = idx.shape
    f = p.shape[1]
    tab = _index_table(idx)
    ws = w_self.to(torch.float32).contiguous()
    wp = w_peer.to(torch.float32).contiguous()
    starts = None
    n_leaves = 0
    if scale is not None:
        n_leaves = scale.shape[1]
        if n_leaves > MAX_LEAVES or k * n_leaves > MAX_SCALES:
            raise ValueError(f"at most {MAX_LEAVES} leaves and {MAX_SCALES} "
                             f"slot x leaf scales, got {k} x {n_leaves}")
        scale = scale.to(torch.float32).contiguous()
        starts = _starts_on(leaf_starts, p.device)
    out = torch.empty_like(p)
    plan = _plan_for(p, h, out, k, scale is not None)
    fn = _build.function(SOURCES[KERNEL_MULTI_DQ], "gather_merge_multi_dq",
                         [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                         + [ctypes.c_void_p] * 5
                         + [ctypes.c_int64, ctypes.c_void_p]
                         + [ctypes.c_int64] * 3 + [ctypes.c_void_p] * 2)
    with torch.cuda.device(p.device):
        rc = fn(p.data_ptr(), h.data_ptr(), WIRE_FORMATS[h.dtype],
                tab.data_ptr(), ws.data_ptr(), wp.data_ptr(),
                None if scale is None else scale.data_ptr(),
                None if starts is None else starts.data_ptr(), n_leaves,
                out.data_ptr(), n, f, k, plan, _build.stream(p))
    _build.raise_if_failed(KERNEL_MULTI_DQ, rc)
    LAUNCHES[KERNEL_MULTI_DQ] += 1
    return out


def gather_merge_multi(p: torch.Tensor, h: torch.Tensor, idx: torch.Tensor,
                       w_self: torch.Tensor, w_peer: torch.Tensor,
                       scale: Optional[torch.Tensor] = None,
                       leaf_starts: LeafStarts = None) -> torch.Tensor:
    """K-slot gather-merge in one pass: on CUDA tensors K1 (float32 ring,
    no scale) or K2 (otherwise), on CPU tensors the plain version. Returns
    a new tensor; ``p`` is not modified."""
    _check_multi(p, h, idx, w_self, w_peer)
    kernel = (KERNEL if h.dtype == torch.float32 and scale is None
              else KERNEL_MULTI_DQ)
    _build.kernel_entry(kernel)
    if p.device.type == "cpu":
        return gather_merge_multi_reference(p, h, idx, w_self, w_peer, scale,
                                            leaf_starts)
    if p.device.type != "cuda":
        raise ValueError(f"no gather_merge_multi for device {p.device}")
    if kernel == KERNEL:
        return gather_merge_multi_cuda(p, h, idx, w_self, w_peer)
    return gather_merge_multi_dq_cuda(p, h, idx, w_self, w_peer, scale,
                                      leaf_starts)


# -- single slot: K3 and K4 --------------------------------------------------

def gather_merge_reference(p: torch.Tensor, h: torch.Tensor,
                           idx: torch.Tensor, w_self: torch.Tensor,
                           w_peer: torch.Tensor,
                           scale: Optional[torch.Tensor] = None,
                           leaf_starts: LeafStarts = None) -> torch.Tensor:
    """Plain PyTorch version of K3/K4, as the JAX package's
    ``gather_merge_reference``: gather, widen, blend; no zero-weight
    mask."""
    scale, leaf_starts = _scale_table(scale, leaf_starts, h.shape[0],
                                      p.shape[1])
    rows = idx.long()
    peer = _widen(h[rows], p.dtype, None if scale is None else scale[rows],
                  leaf_starts)
    return (w_self.to(p.dtype)[:, None] * p
            + w_peer.to(p.dtype)[:, None] * peer)


def _check_flat(p, h, idx, w_self, w_peer):
    if idx.dim() != 1:
        raise ValueError(f"idx must be [N], got shape {tuple(idx.shape)}")
    n = idx.shape[0]
    if p.dim() != 2 or h.dim() != 2 or p.shape[0] != n \
            or h.shape[1] != p.shape[1]:
        raise ValueError(f"shapes do not fit: p {tuple(p.shape)}, "
                         f"h {tuple(h.shape)}, idx {tuple(idx.shape)}")
    if tuple(w_self.shape) != (n,) or tuple(w_peer.shape) != (n,):
        raise ValueError("w_self and w_peer must be [N] like idx")
    _check_devices(p, h, idx, w_self, w_peer)


def _flat_kernel(h: torch.Tensor, scale) -> str:
    """K3 for a float32 ring with no scale, K4 for any other."""
    return (KERNEL_FLAT if h.dtype == torch.float32 and scale is None
            else KERNEL_FLAT_DQ)


class FlatPlan(NamedTuple):
    """How K3/K4 map an ``[N, F]`` call onto the card.

    A row is ``words`` words: 4 columns each in the vector form (``vec``:
    F a multiple of 4 and the operands aligned), 1 in the scalar form. On
    the narrow route a group of ``group`` lanes (the power of two at or
    above ``words``, up to a warp) takes a row, one word a lane, and a
    block of ``threads`` lanes holds ``rows_per_block`` rows; the grid is
    ``(ceil(N / rows), 1)``. On the wide route (``wide``: more than 32
    words) a block of ``threads`` lanes takes a tile of ``tile`` words of
    one row, each lane up to ``words_per_lane`` (``WIDE_WORDS``) of them,
    each warp a group; the grid is ``(N, tiles)``, and the tiles of a row
    are of one size, so the last is not mostly empty (on the narrow route
    ``tile`` is the group)."""
    vec: bool
    wide: bool
    group: int
    threads: int
    grid: tuple
    words: int
    rows_per_block: int
    words_per_lane: int
    tile: int

    def as_args(self):
        """The eight int64 values the C entry points take."""
        return (ctypes.c_int64 * 8)(int(self.vec), int(self.wide),
                                    self.group, self.threads, *self.grid,
                                    self.words_per_lane, self.tile)


@functools.lru_cache(maxsize=1024)
def flat_plan(n: int, f: int, ring_dtype=torch.float32, aligned: bool = True,
              scaled: bool = False) -> FlatPlan:
    """K3/K4's :class:`FlatPlan` for ``n`` rows of ``f`` columns, a ring
    of ``ring_dtype`` (``scaled``: with a scale table) and operands
    ``aligned`` for the vector form (p and out to 16 bytes, ring rows to
    4 values). Every ring takes the same geometry: ``ring_dtype`` is
    checked, and it and ``scaled`` key the cache as the wrapper's call
    does. Raises where the kernel cannot run the call: a grid past the
    card's limits."""
    if ring_dtype not in WIRE_FORMATS:
        raise TypeError(f"ring dtype {ring_dtype} is not a wire format")
    if n < 1 or f < 1:
        raise ValueError(f"no rows or columns: [{n}, {f}]")
    vec = aligned and f % 4 == 0
    words = f // 4 if vec else f
    wide = words > WARP
    if wide:
        group, rows, per_lane = WARP, 1, WIDE_WORDS
        tiles = -(-words // (BLOCK * per_lane))
        tile = -(-words // tiles)
        threads = min(BLOCK, WARP * -(-tile // (per_lane * WARP)))
        grid = (n, tiles)
    else:
        group = _pow2_at_least(words)
        rows, threads, grid = _narrow_layout(n, group)
        per_lane, tile = 1, group
    _check_grid(n, f, grid)
    return FlatPlan(vec, wide, group, threads, grid, words, rows, per_lane,
                    tile)


@functools.lru_cache(maxsize=1024)
def _flat_plan_args(n: int, f: int, ring_dtype, aligned: bool,
                    scaled: bool):
    return flat_plan(n, f, ring_dtype, aligned, scaled).as_args()


def _launch_flat(kernel: str, p, h, idx, w_self, w_peer, scale,
                 leaf_starts) -> torch.Tensor:
    """Launch ``kernel`` (K3 or K4) on operands :func:`_check_flat` has
    passed, on :func:`flat_plan`'s plan for the call."""
    _check_kernel_operands("gather_merge_flat_cuda", p, h)
    tab = _index_table(idx)
    if kernel == KERNEL_FLAT_DQ:
        _check_wire_scale("gather_merge_flat_cuda", h, scale)
    scale, leaf_starts = _scale_table(scale, leaf_starts, h.shape[0],
                                      p.shape[1])
    _check_devices(p, scale)
    n, f = p.shape
    ws = w_self.to(torch.float32).contiguous()
    wp = w_peer.to(torch.float32).contiguous()
    out = torch.empty_like(p)
    args = _flat_plan_args(n, f, h.dtype, _aligned(p, h, out),
                           scale is not None)
    stream = _build.stream(p)
    if kernel == KERNEL_FLAT:
        fn = _build.function(SOURCES[KERNEL_FLAT], "gather_merge_flat",
                             [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 2
                             + [ctypes.c_void_p] * 2)
        with torch.cuda.device(p.device):
            rc = fn(p.data_ptr(), h.data_ptr(), tab.data_ptr(),
                    ws.data_ptr(), wp.data_ptr(), out.data_ptr(), n, f,
                    args, stream)
    else:
        starts = None
        n_leaves = 0
        if scale is not None:
            n_leaves = scale.shape[1]
            if n_leaves > MAX_LEAVES:
                raise ValueError(f"at most {MAX_LEAVES} leaves, got "
                                 f"{n_leaves}")
            scale = scale.to(torch.float32).contiguous()
            starts = _starts_on(leaf_starts, p.device)
        fn = _build.function(SOURCES[KERNEL_FLAT_DQ],
                             "gather_merge_flat_dq",
                             [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                             + [ctypes.c_void_p] * 5
                             + [ctypes.c_int64, ctypes.c_void_p]
                             + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 2)
        with torch.cuda.device(p.device):
            rc = fn(p.data_ptr(), h.data_ptr(), WIRE_FORMATS[h.dtype],
                    tab.data_ptr(), ws.data_ptr(), wp.data_ptr(),
                    None if scale is None else scale.data_ptr(),
                    None if starts is None else starts.data_ptr(), n_leaves,
                    out.data_ptr(), n, f, args, stream)
    _build.raise_if_failed(kernel, rc)
    LAUNCHES[kernel] += 1
    return out


def gather_merge_flat_cuda(p: torch.Tensor, h: torch.Tensor,
                           idx: torch.Tensor, w_self: torch.Tensor,
                           w_peer: torch.Tensor,
                           scale: Optional[torch.Tensor] = None,
                           leaf_starts: LeafStarts = None) -> torch.Tensor:
    """Launch K3 (float32 ring, no scale) or K4 (otherwise); returns a new
    ``[N, F]`` tensor. ``idx`` is int64, as the engine makes it (any other
    type raises), each index in ``[0, M)``; the kernel reads the named
    rows' scales from the ``[M, L]`` table."""
    _check_flat(p, h, idx, w_self, w_peer)
    return _launch_flat(_flat_kernel(h, scale), p, h, idx, w_self, w_peer,
                        scale, leaf_starts)


def gather_merge_flat(p: torch.Tensor, h: torch.Tensor, idx: torch.Tensor,
                      w_self: torch.Tensor, w_peer: torch.Tensor,
                      scale: Optional[torch.Tensor] = None,
                      leaf_starts: LeafStarts = None) -> torch.Tensor:
    """``out[i] = w_self[i] * p[i] + w_peer[i] * peer(idx[i])``: on CUDA
    tensors K3 (float32 ring, no scale) or K4 (otherwise), on CPU tensors
    the plain version. ``idx`` is ``[N]`` (int64 on the card; any integer
    type on the CPU), the weights ``[N]``."""
    _check_flat(p, h, idx, w_self, w_peer)
    kernel = _flat_kernel(h, scale)
    _build.kernel_entry(kernel)
    if p.device.type == "cpu":
        return gather_merge_reference(p, h, idx, w_self, w_peer, scale,
                                      leaf_starts)
    if p.device.type != "cuda":
        raise ValueError(f"no gather_merge_flat for device {p.device}")
    return _launch_flat(kernel, p, h, idx, w_self, w_peer, scale,
                        leaf_starts)


# -- pytree forms ------------------------------------------------------------

def _concat_leaves(params: dict, history: dict, scales: Optional[dict]):
    """Leaves concatenated into ``[N, F]`` rows and a ``[D*N', F]`` ring
    (in the ring's own dtype), the ``[D*N', L]`` scale table and the leaf
    start columns."""
    names = list(params)
    n = params[names[0]].shape[0]
    h0 = history[names[0]]
    m = h0.shape[0] * h0.shape[1]
    widths = [math.prod(params[k].shape[1:]) for k in names]
    p_cat = torch.cat([params[k].reshape(n, -1) for k in names], dim=1)
    h_cat = torch.cat([history[k].reshape(m, -1) for k in names], dim=1)
    scale = starts = None
    if scales is not None:
        scale = torch.stack([scales[k].reshape(m) for k in names], dim=1)
        starts = [0]
        for w in widths[:-1]:
            starts.append(starts[-1] + w)
    return names, widths, p_cat, h_cat, scale, starts


def _split_leaves(out: torch.Tensor, params: dict, names, widths) -> dict:
    parts = torch.split(out, widths, dim=1)
    return {k: part.reshape(params[k].shape) for k, part in zip(names, parts)}


def gather_merge_multi_pytree(params: dict, history: dict,
                              flat_idx: torch.Tensor, w_self: torch.Tensor,
                              w_peer: torch.Tensor,
                              scales: Optional[dict] = None) -> dict:
    """:func:`gather_merge_multi` over named leaves in one launch:
    ``params`` leaves are ``[N, ...]``, ``history`` leaves ``[D, N', ...]``
    (the snapshot ring, addressed as a flat ``[D*N', F]`` table by
    ``flat_idx[i, k] = (send_round % D) * N' + sender``) and ``scales``
    leaves, for a scaled ring, ``[D, N']``. Leaves are concatenated,
    merged and split back."""
    names, widths, p_cat, h_cat, scale, starts = _concat_leaves(
        params, history, scales)
    out = gather_merge_multi(p_cat, h_cat, flat_idx, w_self, w_peer, scale,
                             starts)
    return _split_leaves(out, params, names, widths)


def gather_merge_pytree(params: dict, history: dict, flat_idx: torch.Tensor,
                        w_self: torch.Tensor, w_peer: torch.Tensor,
                        scales: Optional[dict] = None) -> dict:
    """:func:`gather_merge_flat` over named leaves in one launch (the JAX
    package launches once per leaf); layouts as
    :func:`gather_merge_multi_pytree` with ``flat_idx`` and the weights
    ``[N]``."""
    names, widths, p_cat, h_cat, scale, starts = _concat_leaves(
        params, history, scales)
    out = gather_merge_flat(p_cat, h_cat, flat_idx, w_self, w_peer, scale,
                            starts)
    return _split_leaves(out, params, names, widths)
