"""Ring collectives over a mesh's positions.

Counterpart of ``gossipy_tpu/parallel/collectives.py``, whose functions
are ``shard_map`` programs with ``lax.ppermute`` ring schedules. Here the
same schedules run from one controller: a tensor given to a ring
function holds the rows of the mesh positions this process owns, in mesh
order (every row without a process group), each position's rows are its
resident chunk, and a **hop** runs the hop function at every owned
position on the chunk resident there, then rotates the chunks one
position, ``i -> i - 1 mod d`` (the last rotation is skipped). After
``s`` hops position ``m`` holds the chunk that started at ``(m + s) %
d``. A rotation between two positions on one device passes the tensor as
it is; between two cards it is ``.to(device, non_blocking=True)``;
between processes ``torch.distributed.batch_isend_irecv``. Gloo's
point-to-point carries host tensors only, so where ranks are joined by
gloo a chunk on a card crosses through pinned host buffers (copied out
before the send, in after the receive); NCCL carries it as it is.
:data:`TRANSFERS` counts what crosses processes. A rank may own several
positions of the ring (a ``(dcn, nodes)`` mesh's flattened pair, or the
node axis of a ``(nodes, model)`` mesh, at index 0 along the model axis),
a contiguous run of it: a hop passes the chunks between its own
positions as they are, and only the chunk at each end of the run
crosses to the neighbouring rank.

Process-group helpers for the engine on a mesh across ranks:
:func:`rank_all_gather` (every rank's rows, in node order) and
:func:`rank_all_reduce`.

- :func:`ring_all_gather`: every position assembles the whole array.
- :func:`ring_mixed_matmul` / :func:`ring_mix_pytree`: the all-to-all
  mixing merge ``W @ P`` as a ring matmul (its per-hop product is
  ``torch.matmul``, as the JAX package's is jnp).
- :func:`ring_attention`: sequence-parallel attention, K5 on every hop
  (:func:`~gossipy_tpu_torch.ops.attention.flash_hop_update`).
- :func:`sharded_gather_merge_multi`: the engine's multi-slot fused
  merge over the node axis, K1 on every hop
  (:func:`~gossipy_tpu_torch.ops.merge.gather_merge_multi`).

The port compiles nothing, so there is no unrolled-or-rolled choice (the
JAX package's ``_UNROLL_MAX`` and ``fori_loop``): a ring of any size runs
its hops in a Python loop. On CUDA positions every hop launches its
kernel and nothing falls back to the plain versions; on the CPU the same
hops run the plain versions.
"""

from __future__ import annotations

import collections
import math
from typing import Callable, Optional

import numpy as np
import torch

from ..ops import attention as _attention
from ..ops import merge as _merge
from . import _node_axis_entry, _rank, ring_positions

_NEG = _attention._NEG

# What crossed processes: ``ring_hops`` (rotations with a cross-process
# send), ``ring_bytes`` (the bytes this rank sent in them), ``staged_bytes``
# (bytes copied through host buffers for gloo, both ways), ``gathers``
# and ``gather_bytes`` (:func:`rank_all_gather`, this rank's share),
# ``reduces`` (:func:`rank_all_reduce`).
TRANSFERS: collections.Counter = collections.Counter()


def _staged() -> bool:
    """Whether chunks on a card cross processes through host buffers
    (the group's transport is gloo)."""
    return torch.distributed.get_backend() == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` in a pinned host buffer (a card's tensor), counted; a host
    tensor as it is."""
    if t.device.type != "cuda":
        return t.contiguous()
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    TRANSFERS["staged_bytes"] += buf.numel() * buf.element_size()
    return buf


def _host_like(t: torch.Tensor) -> torch.Tensor:
    """An empty receive buffer for ``t``: pinned on the host for a card's
    tensor under gloo, else like ``t``."""
    if t.device.type == "cuda" and _staged():
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return torch.empty_like(t)


def _from_host(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if buf.device == like.device:
        return buf
    TRANSFERS["staged_bytes"] += buf.numel() * buf.element_size()
    return buf.to(like.device)


def _rank_order(mesh) -> list:
    """The ranks in node order (by their first node-axis position)."""
    first: dict = {}
    for m, p in enumerate(ring_positions(mesh)):
        first.setdefault(p.rank, m)
    return sorted(first, key=first.get)


def rank_all_gather(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (its rows of a node-axis leaf) concatenated along
    ``dim`` in node order, on ``x``'s device: a collective every rank of
    the mesh calls with a tensor of one shape. Under gloo a card's tensor
    crosses through host buffers."""
    dist = torch.distributed
    send = _to_host(x) if _staged() else x.contiguous()
    parts = [torch.empty_like(send) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, send)
    TRANSFERS["gathers"] += 1
    TRANSFERS["gather_bytes"] += send.numel() * send.element_size()
    out = torch.cat([parts[r] for r in _rank_order(mesh)], dim=dim)
    return _from_host(out, x)


def rank_all_reduce(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``x`` summed (``op="sum"``) or maxed (``"max"``) over the ranks of
    the process group, on ``x``'s device (a new tensor)."""
    dist = torch.distributed
    buf = _to_host(x).clone() if _staged() else x.clone()
    dist.all_reduce(buf, {"sum": dist.ReduceOp.SUM,
                          "max": dist.ReduceOp.MAX}[op])
    TRANSFERS["reduces"] += 1
    return _from_host(buf, x)


def _ring_perm(d: int):
    """Send each chunk to the previous ring position (i -> i-1 mod d), so
    after ``s`` hops position ``m`` holds the chunk that started on
    position ``(m + s) % d``."""
    return [(i, (i - 1) % d) for i in range(d)]


def _axis_size(mesh, axis_name) -> int:
    """Ring length: the mesh axis size, or the product over a tuple of
    axes (positions in flattened order)."""
    names = axis_name if isinstance(axis_name, tuple) else (axis_name,)
    d = 1
    for a in names:
        d *= int(mesh.shape[a])
    return d


class _Ring:
    """The positions a ring over ``axis_name`` visits, in ring order (the
    flattened order of the ring's axes; on a mesh with other axes, the
    positions at index 0 along them), and the ones this process owns."""

    def __init__(self, mesh, axis_name):
        self.positions = ring_positions(mesh, axis_name)
        self.d = len(self.positions)
        me = _rank()
        self.local = [m for m, p in enumerate(self.positions) if p.rank == me]
        if not self.local:
            raise ValueError(f"this process (rank {me}) owns no position of "
                             "the ring")
        self._slot = {m: i for i, m in enumerate(self.local)}

    def device(self, m: int) -> torch.device:
        return self.positions[m].device

    def split(self, x: torch.Tensor, dim: int = 0) -> dict:
        """An owned-rows tensor as ``{position: its chunk}`` (each chunk on
        its position's device)."""
        if x.shape[dim] % len(self.local):
            raise ValueError(f"{x.shape[dim]} rows do not split over the "
                             f"{len(self.local)} positions this process "
                             "owns")
        nl = x.shape[dim] // len(self.local)
        return {m: x.narrow(dim, i * nl, nl).to(self.device(m))
                for i, m in enumerate(self.local)}

    def join(self, parts: dict, dim: int = 0) -> torch.Tensor:
        """Owned positions' results concatenated in ring order, on the
        first owned position's device."""
        dev = self.device(self.local[0])
        return torch.cat([parts[m].to(dev) for m in self.local], dim=dim)

    def rotate(self, chunks: dict) -> dict:
        """One hop of the ring: position ``m`` receives the chunk of
        position ``m + 1`` (a tensor, or a tuple of tensors that travel
        together). Across processes the chunks go by
        ``batch_isend_irecv``, through host buffers under gloo."""
        d = self.d
        out: dict = {}
        ops: list = []
        recv: dict = {}
        dist = torch.distributed
        for m in self.local:
            src = (m + 1) % d
            if src in self._slot:
                out[m] = _move(chunks[src], self.device(m))
            else:
                like = chunks[m]
                bufs = tuple(_host_like(t) for t in _as_tuple(like))
                recv[m] = bufs
                for j, b in enumerate(bufs):
                    ops.append(dist.P2POp(dist.irecv, b,
                                          self.positions[src].rank,
                                          tag=src * 8 + j))
        sent = 0
        for m in self.local:
            dst = (m - 1) % d
            if dst not in self._slot:
                for j, t in enumerate(_as_tuple(chunks[m])):
                    t = _to_host(t) if _staged() else t.contiguous()
                    sent += t.numel() * t.element_size()
                    ops.append(dist.P2POp(dist.isend, t,
                                          self.positions[dst].rank,
                                          tag=m * 8 + j))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            TRANSFERS["ring_hops"] += 1
            TRANSFERS["ring_bytes"] += sent
            for m, bufs in recv.items():
                got = tuple(_from_host(b, t) for b, t in
                            zip(bufs, _as_tuple(chunks[m])))
                out[m] = got if isinstance(chunks[m], tuple) else got[0]
        return out


def _as_tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def _move(x, dev):
    if isinstance(x, tuple):
        return tuple(t.to(dev, non_blocking=True) for t in x)
    return x.to(dev, non_blocking=True)


def _ring_hops(ring: _Ring, hop: Callable, carry: dict, chunk: dict) -> dict:
    """Run ``d`` ring hops: at every owned position ``m``, ``carry[m] =
    hop(s, m, carry[m], chunk[m])``, then rotate the chunks one position
    (the final rotation is skipped); returns the final carries."""
    for s in range(ring.d):
        carry = {m: hop(s, m, carry[m], chunk[m]) for m in ring.local}
        if s != ring.d - 1:
            chunk = ring.rotate(chunk)
    return carry


def _ring_for(mesh, axis_name):
    axis_name = _node_axis_entry(mesh, axis_name)
    return _Ring(mesh, axis_name)


def ring_all_gather(x: torch.Tensor, mesh, axis_name=None) -> torch.Tensor:
    """All-gather ``x`` (this process's positions' rows) via the ring: every
    position assembles the whole ``[d * rows, ...]`` array; returns it
    (on the first owned position's device). ``axis_name`` defaults to the
    mesh-derived node placement."""
    ring = _ring_for(mesh, axis_name)
    d = ring.d
    chunks = ring.split(x)
    nl = chunks[ring.local[0]].shape[0]
    n = nl * d

    def hop(s, m, out, ch):
        src = (m + s) % d
        out[src * nl:(src + 1) * nl] = ch
        return out

    carry = {m: torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                            device=ring.device(m)) for m in ring.local}
    return _ring_hops(ring, hop, carry, chunks)[ring.local[0]]


def ring_mixed_matmul(w: torch.Tensor, x: torch.Tensor, mesh,
                      axis_name=None) -> torch.Tensor:
    """``w @ x`` with ``x`` on the node axis, as a ring matmul: per hop each
    position contracts its resident chunk of senders against the matching
    column block of its ``w`` rows, then the chunk rotates. ``w`` holds
    this process's receiver rows of the ``[N, N]`` matrix (all of it
    without a process group), ``x`` the same rows of ``[N, F]``; the
    result is ``x``'s rows, in ``x``'s type."""
    ring = _ring_for(mesh, axis_name)
    d = ring.d
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[0]:
        raise ValueError(f"mixing rows {tuple(w.shape)} vs node rows "
                         f"{tuple(x.shape)}")
    chunks = ring.split(x)
    w_rows = ring.split(w)
    nl = chunks[ring.local[0]].shape[0]
    if w.shape[1] != nl * d:
        raise ValueError(f"mixing matrix has {w.shape[1]} columns, the ring "
                         f"{nl * d} nodes")
    dt = torch.promote_types(w.dtype, x.dtype)

    def hop(s, m, acc, ch):
        src = (m + s) % d
        return acc + w_rows[m][:, src * nl:(src + 1) * nl].to(dt) @ ch.to(dt)

    carry = {m: torch.zeros((nl, x.shape[1]), dtype=dt, device=ring.device(m))
             for m in ring.local}
    out = _ring_hops(ring, hop, carry, chunks)
    return ring.join(out).to(x.dtype)


def _flatten_rows(params):
    """``(cat [N, sum F], rebuild)`` of a ``[N, ...]`` tensor or a dict of
    them (leaves in sorted key order, as the JAX package flattens a
    dict)."""
    if isinstance(params, torch.Tensor):
        n = params.shape[0]
        flat = params.reshape(n, -1)
        return flat, lambda out: out.reshape(params.shape).to(params.dtype)
    keys = sorted(params)
    n = params[keys[0]].shape[0]
    flats = [params[k].reshape(n, -1) for k in keys]
    widths = [f.shape[1] for f in flats]
    dt = flats[0].dtype
    for f in flats[1:]:
        dt = torch.promote_types(dt, f.dtype)
    cat = torch.cat([f.to(dt) for f in flats], dim=1)

    def rebuild(out):
        parts = torch.split(out, widths, dim=1)
        return {k: p.reshape(params[k].shape).to(params[k].dtype)
                for k, p in zip(keys, parts)}

    return cat, rebuild


def ring_mix_pytree(w: torch.Tensor, params, mesh, axis_name=None):
    """:func:`ring_mixed_matmul` over stacked ``[N, ...]`` params (a tensor,
    the engine's flat ``[N, stride]`` rows, or a dict of leaves): the
    leaves ride one ring concatenated and are split back, each in its own
    type."""
    cat, rebuild = _flatten_rows(params)
    return rebuild(ring_mixed_matmul(w, cat, mesh, axis_name))


def _ring_attention_2d(q, k, v, ring, causal, hop_fn):
    d = ring.d
    s_own, dim = q.shape
    if k.shape != (s_own, dim):
        raise ValueError(f"k {tuple(k.shape)} must match q {(s_own, dim)}")
    if v.shape[0] != s_own:
        raise ValueError(f"v has {v.shape[0]} rows, expected {s_own}")
    qs, ks, vs = ring.split(q), ring.split(k), ring.split(v)
    sl = qs[ring.local[0]].shape[0]
    dv = v.shape[1]
    scale = 1.0 / math.sqrt(dim)
    wd = torch.float64 if q.dtype == torch.float64 else torch.float32

    def hop(s, m, carry, kv):
        src = (m + s) % d
        return hop_fn(qs[m], kv[0], kv[1], *carry, m * sl, src * sl, scale,
                      causal)

    carry = {m: (torch.full((sl,), _NEG, dtype=wd, device=ring.device(m)),
                 torch.zeros((sl,), dtype=wd, device=ring.device(m)),
                 torch.zeros((sl, dv), dtype=wd, device=ring.device(m)))
             for m in ring.local}
    out = _ring_hops(ring, hop, carry, {m: (ks[m], vs[m]) for m in ring.local})
    parts = {m: (acc / torch.clamp(l, min=1e-30)[:, None]).to(q.dtype)
             for m, (_, l, acc) in out.items()}
    return ring.join(parts)


def _ring_attention(q, k, v, mesh, axis_name, causal, hop_fn):
    ring = _ring_for(mesh, axis_name)
    if q.dim() < 2:
        raise ValueError("q, k and v must be [..., S, D]")
    if q.dim() == 2:
        return _ring_attention_2d(q, k, v, ring, causal, hop_fn)
    lead = q.shape[:-2]
    qf = q.reshape((-1,) + tuple(q.shape[-2:]))
    kf = k.reshape((-1,) + tuple(k.shape[-2:]))
    vf = v.reshape((-1,) + tuple(v.shape[-2:]))
    outs = [_ring_attention_2d(qf[i], kf[i], vf[i], ring, causal, hop_fn)
            for i in range(qf.shape[0])]
    return torch.stack(outs).reshape(tuple(lead) + tuple(outs[0].shape))


def _flash_hop(q, k_c, v_c, m, l, acc, q_off, k_off, scale, causal):
    return _attention.flash_hop_update(q, k_c, v_c, m, l, acc, q_off, k_off,
                                       scale, causal=causal)


def _plain_hop(q, k_c, v_c, m, l, acc, q_off, k_off, scale, causal):
    return _attention.hop_update_reference(q, k_c, v_c, m, l, acc, q_off,
                                           k_off, scale, causal)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis_name=None, causal: bool = False,
                   flash: Optional[bool] = None) -> torch.Tensor:
    """Sequence-parallel attention over the ring (blockwise softmax).

    ``q``/``k``/``v`` are ``[S, D]`` (``[S, Dv]`` for ``v``), the sequence
    on the node axis: each position keeps its query block while the
    key/value blocks rotate, carrying the streaming-softmax statistics
    ``(m, l, acc)``, so no position holds the ``[S, S]`` scores or the
    whole key/value sequence. The hop order is the JAX package's (hop
    ``s`` at position ``m`` absorbs block ``(m + s) % d``, offsets ``m·sl``
    and ``src·sl``), which the streaming softmax's rounding depends on.
    ``causal=True`` masks by global position. Leading head or batch axes
    (``[..., S, D]``) run one ring per head, as the JAX package's users
    ``jax.vmap`` it.

    ``flash`` picks the hop: K5 (:func:`~gossipy_tpu_torch.ops.attention.
    flash_hop_update`, the kernel on CUDA positions, its plain version on
    CPU ones) or the plain hop body (``hop_update_reference``, the JAX
    package's jnp body). ``None`` means K5 on CUDA and the plain body on
    the CPU, as the JAX package means the kernel on TPU; the plain body is
    refused on CUDA positions (the card runs the kernel). Both are
    differentiable in one process; a gradient does not cross processes.
    """
    ring = _ring_for(mesh, axis_name)
    cuda = ring.device(ring.local[0]).type == "cuda"
    if flash is None:
        flash = cuda
    if not flash and cuda:
        raise ValueError("ring_attention(flash=False) is the CPU's plain hop; "
                         "on CUDA positions every hop runs K5")
    return _ring_attention(q, k, v, mesh, axis_name, causal,
                           _flash_hop if flash else _plain_hop)


def _widened_chunks(ring, history, scales, leaf_starts, dtype):
    """Each owned position's ``[D * nl, F]`` ring chunk, widened to
    ``dtype`` (times its scales by column leaf) where it lives, before it
    enters the ring."""
    D = history.shape[0]
    hs = ring.split(history, dim=1)
    ss = ring.split(scales, dim=1) if scales is not None else None
    out = {}
    for m in ring.local:
        h = hs[m]
        rows = h.reshape(D * h.shape[1], h.shape[2])
        sc = None
        if ss is not None:
            s = ss[m]
            sc = s.reshape(D * s.shape[1], -1)
        if sc is None and rows.dtype == dtype:
            out[m] = rows.contiguous()
        else:
            scale, starts = _merge._scale_table(sc, leaf_starts, rows.shape[0],
                                                rows.shape[1])
            out[m] = _merge._widen(rows, dtype, scale, starts).contiguous()
    return out


def _sharded_merge(params, history, flat_idx, w_self, w_peer, mesh, scales,
                   axis_name, leaf_starts, merge: Callable):
    ring = _ring_for(mesh, axis_name)
    d = ring.d
    if isinstance(params, dict):
        keys = sorted(params)
        p_cat, rebuild = _flatten_rows(params)
        D = history[keys[0]].shape[0]
        h_cat = torch.cat([history[k].reshape(D, history[k].shape[1], -1)
                           for k in keys], dim=2)
        if scales is not None:
            scales = torch.stack([scales[k].reshape(D, -1) for k in keys],
                                 dim=2)
            starts = [0]
            for k in keys[:-1]:
                starts.append(starts[-1] + math.prod(params[k].shape[1:]))
            leaf_starts = starts
    else:
        p_cat, rebuild = _flatten_rows(params)
        h_cat = history.reshape(history.shape[0], history.shape[1], -1)
    n_own, fsum = p_cat.shape
    if n_own % len(ring.local):
        raise ValueError(f"node axis {n_own} not divisible by mesh axis {d}")
    nl = n_own // len(ring.local)
    n = nl * d
    D = h_cat.shape[0]
    dt = torch.float32 if p_cat.dtype != torch.float64 else torch.float64
    p_cat = p_cat.to(dt)

    # Composed linear weights (hop-order independent): W0 = prod_k ws_k,
    # Wk = wp_k * prod_{j>k} ws_j.
    ws = w_self.to(dt)
    wp = w_peer.to(dt)
    rev = torch.cumprod(ws.flip(1), dim=1).flip(1)    # prod_{j>=k} ws_j
    w0 = rev[:, 0]
    suffix = torch.cat([rev[:, 1:], torch.ones((n_own, 1), dtype=dt,
                                               device=rev.device)], dim=1)
    wk = wp * suffix

    chunks = _widened_chunks(ring, h_cat, scales, leaf_starts, dt)
    p_l, idx_l, w0_l, wk_l = (ring.split(t) for t in (p_cat, flat_idx, w0,
                                                       wk))
    # Every hop's table at once, ``[d, nl, K]`` a position (hop ``s``
    # holds the chunk that started at ``(m + s) % d``): the slot's row in
    # the resident chunk, clamped, and its weight where the sender is
    # resident, else 0.
    tables = {}
    hops = torch.arange(d, device=p_cat.device)
    for m in ring.local:
        idx = idx_l[m].long()
        bb, ss = idx // n, idx % n    # ring cell and global sender
        lo = (((m + hops) % d) * nl).to(idx.device)[:, None, None]
        lidx = torch.clamp(bb * nl + (ss - lo), 0, D * nl - 1)
        wp_hop = torch.where((ss >= lo) & (ss < lo + nl), wk_l[m],
                             torch.zeros((), dtype=dt, device=idx.device))
        tables[m] = (lidx, wp_hop, torch.ones_like(wk_l[m]))

    def hop(s, m, acc, ch):
        lidx, wp_hop, ones = tables[m]
        return merge(acc, ch, lidx[s], ones, wp_hop[s])

    carry = {m: (w0_l[m][:, None] * p_l[m]).contiguous() for m in ring.local}
    out = _ring_hops(ring, hop, carry, chunks)
    return rebuild(ring.join(out))


def sharded_gather_merge_multi(params, history, flat_idx: torch.Tensor,
                               w_self: torch.Tensor, w_peer: torch.Tensor,
                               mesh, scales=None, axis_name=None,
                               leaf_starts=None):
    """The engine's multi-slot fused merge over the mesh's node axis: each
    position merges its own receiver rows while the ring chunks rotate,
    one K1 launch a position a hop (``d²`` launches a call on a ring of
    ``d``), each folding in the slots whose sender is resident.

    ``params`` is ``[N, F]`` (the engine's flat rows; a dict of ``[N,
    ...]`` leaves is concatenated), ``history`` the ``[D, N, F]`` ring in
    float32 or a wire format, ``scales`` its ``[D, N, L]`` scale sidecar
    with ``leaf_starts`` (a dict form takes ``[D, N]`` scales per leaf),
    ``flat_idx``/``w_self``/``w_peer`` the ``[N, K]`` tables of
    :func:`~gossipy_tpu_torch.ops.merge.gather_merge_multi` with global
    indices ``cell * N + sender``; with a process group, each holds this
    process's positions' rows.

    A rotating accumulation cannot honour slot order, so the left-to-right
    fold is first rewritten in its composed linear form::

        out = (prod_k ws_k) * p + sum_k [wp_k * prod_{j>k} ws_j] * peer_k

    which is hop-order independent — equal to the unsharded fold up to
    float reassociation. A bf16 or int8 ring is widened to float32 where
    it lives, before the chunk enters the ring (as the JAX package does),
    so K1, not K2, runs on every hop. The per-hop table is the int64
    table K1 reads (the JAX package's is int32).
    """
    return _sharded_merge(params, history, flat_idx, w_self, w_peer, mesh,
                          scales, axis_name, leaf_starts,
                          lambda *a: _merge.gather_merge_multi(*a))
