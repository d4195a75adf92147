"""Core protocol primitives: enums, the dense and sparse topologies, the
mixing weights, delay models.

Counterpart of ``gossipy_tpu/core.py``. A topology is host-side numpy: a
dense bool adjacency (:class:`Topology`) or CSR neighbour lists
(:class:`SparseTopology`, O(E) memory, for populations where an ``[N,
N]`` adjacency no longer fits); the simulator copies it to its device
once. Peer draws and random delays go through the simulation's
:class:`~gossipy_tpu_torch.random.DrawProvider`: a uniform neighbour of a
dense row is the JAX package's categorical, of a CSR row its ``randint``
into the row.

The generators have the JAX package's backends: networkx's algorithms,
copied below so that the port needs no networkx and the edge set equals
the JAX package's for every seed, and the native C++ generators of
:mod:`gossipy_tpu_torch.native` (a copy of the JAX package's source),
which ``"auto"`` takes from ``NATIVE_THRESHOLD`` nodes on. The mixing
weights of the all-to-all simulator are a dense ``[N, N]`` matrix over a
:class:`Topology` and O(E) edge weights (:class:`SparseMixing`) over a
:class:`SparseTopology`.
"""

from __future__ import annotations

import dataclasses
import random
from collections import defaultdict
from enum import IntEnum
from itertools import combinations
from typing import NamedTuple, Optional

import numpy as np
import torch


class CreateModelMode(IntEnum):
    """Merge discipline on message receipt."""

    UPDATE = 1
    MERGE_UPDATE = 2
    UPDATE_MERGE = 3
    PASS = 4


class AntiEntropyProtocol(IntEnum):
    """Gossip exchange protocol."""

    PUSH = 1
    PULL = 2
    PUSH_PULL = 3


class MessageType(IntEnum):
    """Wire message type."""

    PUSH = 1
    PULL = 2
    REPLY = 3
    PUSH_PULL = 4


class Topology:
    """A static P2P topology as a dense bool adjacency ``[N, N]``.

    Self-loops are removed; row ``i`` lists node ``i``'s out-neighbours.
    """

    # Node count from which the JAX package's "auto" backend switches to its
    # native generators (another edge set for the same seed).
    NATIVE_THRESHOLD = 2048

    def __init__(self, adjacency: np.ndarray):
        adjacency = np.asarray(adjacency)
        if adjacency.ndim != 2 or adjacency.shape[0] != adjacency.shape[1]:
            raise ValueError("adjacency must be a square matrix")
        adj = adjacency.astype(bool)
        np.fill_diagonal(adj, False)
        self.num_nodes: int = adj.shape[0]
        self.adjacency: np.ndarray = adj
        self.degrees: np.ndarray = adj.sum(axis=1).astype(np.int32)

    @staticmethod
    def clique(n: int) -> "Topology":
        """Fully-connected topology."""
        return Topology(np.ones((n, n), dtype=bool))

    @staticmethod
    def ring(n: int, k: int = 1) -> "Topology":
        """Ring lattice: each node links to its ``k`` nearest neighbours on
        each side."""
        a = np.zeros((n, n), dtype=bool)
        idx = np.arange(n)
        for d in range(1, k + 1):
            a[idx, (idx + d) % n] = True
            a[idx, (idx - d) % n] = True
        return Topology(a)

    @staticmethod
    def _use_native(n: int, backend: str) -> bool:
        """Whether a generator call takes the native generator: always
        under ``"native"`` (which raises when the library cannot be
        built), never under ``"networkx"``, and under ``"auto"`` from
        ``NATIVE_THRESHOLD`` nodes on when the library can be built,
        with the JAX package's warning that the edge set then differs
        from networkx's for the same seed."""
        if backend not in ("auto", "networkx", "native"):
            raise ValueError("backend must be 'auto', 'networkx' or "
                             f"'native', got {backend!r}")
        if backend == "networkx":
            return False
        from . import native
        if backend == "native":
            native.load()
            return True
        if n >= Topology.NATIVE_THRESHOLD and native.available():
            from . import LOG
            LOG.warning(
                "Topology backend='auto' selected the native generator for "
                "n=%d (threshold %d): edge sets differ from networkx's RNG "
                "stream. Pin backend='native' or backend='networkx' for "
                "cross-size reproducibility.", n, Topology.NATIVE_THRESHOLD)
            return True
        return False

    @staticmethod
    def _from_edges(n: int, edges) -> "Topology":
        a = np.zeros((n, n), dtype=bool)
        for s1, s2 in edges:
            a[s1, s2] = a[s2, s1] = True
        return Topology(a)

    @staticmethod
    def random_regular(n: int, degree: int, seed: int = 42,
                       backend: str = "auto") -> "Topology":
        """Random ``degree``-regular graph on ``n`` nodes: the edge set of
        networkx's ``random_regular_graph(degree, n, seed)``
        (``backend="networkx"``) or of the native pairing model
        (``"native"``); ``"auto"`` takes the second from
        ``NATIVE_THRESHOLD`` nodes on (:meth:`_use_native`)."""
        if Topology._use_native(n, backend):
            from . import native
            return Topology(native.random_regular(n, degree, seed))
        return Topology._from_edges(
            n, _random_regular_edges(degree, n, random.Random(seed)))

    @staticmethod
    def barabasi_albert(n: int, m: int, seed: int = 42,
                        backend: str = "auto") -> "Topology":
        """Preferential-attachment graph on ``n`` nodes, ``m`` edges from
        each new node: networkx's ``barabasi_albert_graph(n, m, seed)`` or
        the native generator, chosen as in :meth:`random_regular`."""
        if Topology._use_native(n, backend):
            from . import native
            return Topology(native.barabasi_albert(n, m, seed))
        return Topology._from_edges(
            n, _barabasi_albert_edges(n, m, random.Random(seed)))

    @staticmethod
    def erdos_renyi(n: int, p: float, seed: int = 42,
                    backend: str = "auto") -> "Topology":
        """G(n, p): each of the ``n (n - 1) / 2`` pairs an edge with
        probability ``p``, networkx's ``erdos_renyi_graph(n, p, seed)`` or
        the native generator, chosen as in :meth:`random_regular`."""
        if Topology._use_native(n, backend):
            from . import native
            return Topology(native.erdos_renyi(n, p, seed))
        return Topology._from_edges(n, _gnp_edges(n, p, random.Random(seed)))

    def get_peers(self, node_id: int) -> list[int]:
        """Peer ids of one node."""
        return list(np.where(self.adjacency[node_id])[0])

    def size(self, node: Optional[int] = None) -> int:
        """Number of nodes, or the degree of ``node`` if given (node 0
        too: the original gossipy's ``if node:`` gives it the node count)."""
        if node is None:
            return self.num_nodes
        return int(self.degrees[node])

    def adjacency_on(self, device: torch.device) -> torch.Tensor:
        """The adjacency as a bool tensor on ``device``."""
        return torch.as_tensor(self.adjacency, device=device)

    def sample_peers(self, generator: torch.Generator) -> torch.Tensor:
        """One uniform neighbour for every node under ``generator``, int32
        ``[N]`` on the host; -1 for a node with no neighbour (callers mask
        those sends). :func:`sample_peers` over this adjacency."""
        return sample_peers(generator, self.adjacency)


def sample_peers(generator: torch.Generator, adjacency) -> torch.Tensor:
    """One uniform neighbour for every row of a bool adjacency ``[N, N]``
    (numpy or a tensor), int32 ``[N]`` on the adjacency's device; -1 for
    a row with no neighbour.

    The engine's own draw: :meth:`~gossipy_tpu_torch.random.TorchDraws.
    peers` with the caller's CPU ``generator`` as its stream, so the same
    generator state gives the peers a run would draw. The JAX package's
    ``sample_peers(key, adjacency)`` is a categorical under a threefry
    key; the two agree in law, not in values.
    """
    from .random import TorchDraws
    adj = torch.as_tensor(adjacency, dtype=torch.bool)
    return TorchDraws(generator=generator).peers(0, adj).to(torch.int32)


# The pairing algorithm of networkx 3.6.1's ``random_regular_graph``
# (networkx/generators/random_graphs.py:524), its preferential
# attachment, ``barabasi_albert_graph`` with ``_random_subset``, and its
# ``gnp_random_graph`` (the same file), copied so that the port needs no
# networkx. Their only randomness is ``rng.shuffle`` of the stubs,
# ``rng.choice`` of the repeated-node list and ``rng.random()`` per pair,
# with ``rng = random.Random(seed)`` as networkx's ``py_random_state``
# makes it.
#
# Copyright (C) 2004-2025, NetworkX Developers
# Aric Hagberg <hagberg@lanl.gov>
# Dan Schult <dschult@colgate.edu>
# Pieter Swart <swart@lanl.gov>
# All rights reserved.
#
# Redistribution and use in source and binary forms, with or without
# modification, are permitted provided that the following conditions are
# met:
#
#   * Redistributions of source code must retain the above copyright
#     notice, this list of conditions and the following disclaimer.
#   * Redistributions in binary form must reproduce the above copyright
#     notice, this list of conditions and the following disclaimer in the
#     documentation and/or other materials provided with the distribution.
#   * Neither the name of the NetworkX Developers nor the names of its
#     contributors may be used to endorse or promote products derived from
#     this software without specific prior written permission.
#
# THIS SOFTWARE IS PROVIDED BY THE COPYRIGHT HOLDERS AND CONTRIBUTORS "AS
# IS" AND ANY EXPRESS OR IMPLIED WARRANTIES, INCLUDING, BUT NOT LIMITED TO,
# THE IMPLIED WARRANTIES OF MERCHANTABILITY AND FITNESS FOR A PARTICULAR
# PURPOSE ARE DISCLAIMED. IN NO EVENT SHALL THE COPYRIGHT OWNER OR
# CONTRIBUTORS BE LIABLE FOR ANY DIRECT, INDIRECT, INCIDENTAL, SPECIAL,
# EXEMPLARY, OR CONSEQUENTIAL DAMAGES (INCLUDING, BUT NOT LIMITED TO,
# PROCUREMENT OF SUBSTITUTE GOODS OR SERVICES; LOSS OF USE, DATA, OR
# PROFITS; OR BUSINESS INTERRUPTION) HOWEVER CAUSED AND ON ANY THEORY OF
# LIABILITY, WHETHER IN CONTRACT, STRICT LIABILITY, OR TORT (INCLUDING
# NEGLIGENCE OR OTHERWISE) ARISING IN ANY WAY OUT OF THE USE OF THIS
# SOFTWARE, EVEN IF ADVISED OF THE POSSIBILITY OF SUCH DAMAGE.

def _random_regular_edges(d: int, n: int, rng: random.Random) -> set:
    """The edge set ``{(s1, s2)}``, ``s1 < s2``, of a random d-regular
    graph on nodes ``0..n-1`` (Steger and Wormald's pairing, started again
    until it succeeds)."""
    if (n * d) % 2 != 0:
        raise ValueError("n * d must be even")
    if not 0 <= d < n:
        raise ValueError("the 0 <= d < n inequality must be satisfied")
    if d == 0:
        return set()

    def suitable(edges, potential_edges):
        # Whether an edge can still be formed among the leftover stubs.
        if not potential_edges:
            return True
        for s1 in potential_edges:
            for s2 in potential_edges:
                if s1 == s2:
                    break
                if s1 > s2:
                    s1, s2 = s2, s1
                if (s1, s2) not in edges:
                    return True
        return False

    def try_creation():
        edges = set()
        stubs = list(range(n)) * d
        while stubs:
            potential_edges = defaultdict(lambda: 0)
            rng.shuffle(stubs)
            stubiter = iter(stubs)
            for s1, s2 in zip(stubiter, stubiter):
                if s1 > s2:
                    s1, s2 = s2, s1
                if s1 != s2 and ((s1, s2) not in edges):
                    edges.add((s1, s2))
                else:
                    potential_edges[s1] += 1
                    potential_edges[s2] += 1
            if not suitable(edges, potential_edges):
                return None
            stubs = [node for node, potential in potential_edges.items()
                     for _ in range(potential)]
        return edges

    edges = try_creation()
    while edges is None:
        edges = try_creation()
    return edges


def _barabasi_albert_edges(n: int, m: int, rng: random.Random) -> list:
    """The edges ``(source, target)`` of a Barabasi-Albert graph grown
    from ``star_graph(m)`` (hub 0, spokes ``1..m``): each new node draws
    ``m`` distinct targets uniformly from the list of existing nodes, each
    repeated once per incident edge. The targets are a set, iterated in
    the order CPython gives a set of ints, as networkx iterates it."""
    if m < 1 or m >= n:
        raise ValueError("Barabasi-Albert needs 1 <= m < n, got "
                         f"m = {m}, n = {n}")
    edges = [(0, j) for j in range(1, m + 1)]
    repeated = [0] * m + list(range(1, m + 1))
    for source in range(m + 1, n):
        targets = set()
        while len(targets) < m:
            targets.add(rng.choice(repeated))
        edges.extend((source, t) for t in targets)
        repeated.extend(targets)
        repeated.extend([source] * m)
    return edges


def _gnp_edges(n: int, p: float, rng: random.Random) -> list:
    """The edges of G(n, p): every pair ``(i, j)``, ``i < j``, in
    ``combinations`` order, kept when ``rng.random() < p`` (all of them
    for ``p >= 1``, none for ``p <= 0``, drawing nothing)."""
    if p >= 1:
        return list(combinations(range(n), 2))
    if p <= 0:
        return []
    return [e for e in combinations(range(n), 2) if rng.random() < p]


class CSR(NamedTuple):
    """A :class:`SparseTopology`'s neighbour lists as int64 tensors on one
    device: ``indptr`` ``[N + 1]``, ``indices`` ``[2E]``, ``degrees``
    ``[N]``."""

    indptr: torch.Tensor
    indices: torch.Tensor
    degrees: torch.Tensor


class SparseTopology:
    """A static topology as CSR neighbour lists, for node counts where a
    dense ``[N, N]`` adjacency no longer fits (2.5 GB of bools at 50,000
    nodes, 20 GB of the float64 fan-in product).

    ``indices`` ``[2E]`` int32 lists each node's neighbours in id order,
    row by row; ``indptr`` ``[N + 1]`` int32 holds the rows' offsets;
    ``degrees`` ``[N]`` int32. The query surface is :class:`Topology`'s
    (``num_nodes``, ``degrees``, ``get_peers``, ``size``) and the engine
    runs on either; ``adjacency`` raises, so nothing builds an ``[N, N]``
    by accident. A uniform peer draw is a ``randint(degree)`` into the row
    (:meth:`~gossipy_tpu_torch.random.DrawProvider.csr_peers`).
    """

    def __init__(self, num_nodes: int, edges: np.ndarray):
        """``edges``: the undirected edge list ``[E, 2]``, each edge once,
        without self-loops (the generators give it so)."""
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        n = int(num_nodes)
        src = np.concatenate([edges[:, 0], edges[:, 1]])
        dst = np.concatenate([edges[:, 1], edges[:, 0]])
        order = np.lexsort((dst, src))  # rows ascending, sorted within row
        self.num_nodes = n
        self.indices: np.ndarray = dst[order].astype(np.int32)
        counts = np.bincount(src, minlength=n).astype(np.int64)
        self.indptr: np.ndarray = np.concatenate(
            [[0], np.cumsum(counts)]).astype(np.int32)
        self.degrees: np.ndarray = counts.astype(np.int32)
        self._on: dict = {}

    # -- constructors: the native edge-list generators, O(E) throughout ------

    @staticmethod
    def random_regular(n: int, degree: int, seed: int = 42
                       ) -> "SparseTopology":
        from . import native
        return SparseTopology(n, native.random_regular_edges(n, degree, seed))

    @staticmethod
    def erdos_renyi(n: int, p: float, seed: int = 42) -> "SparseTopology":
        from . import native
        return SparseTopology(n, native.erdos_renyi_edges(n, p, seed))

    @staticmethod
    def barabasi_albert(n: int, m: int, seed: int = 42) -> "SparseTopology":
        from . import native
        return SparseTopology(n, native.barabasi_albert_edges(n, m, seed))

    @staticmethod
    def ring(n: int, k: int = 1) -> "SparseTopology":
        """Ring lattice, ``k`` neighbours a side (an antipodal pair is one
        edge)."""
        idx = np.arange(n, dtype=np.int64)
        edges = []
        for d in range(1, k + 1):
            if 2 * d < n:
                edges.append(np.stack([idx, (idx + d) % n], axis=1))
            elif 2 * d == n:
                half = idx[: n // 2]
                edges.append(np.stack([half, half + n // 2], axis=1))
        return SparseTopology(n, np.concatenate(edges) if edges
                              else np.empty((0, 2), np.int64))

    @staticmethod
    def from_dense(topology: Topology) -> "SparseTopology":
        i, j = np.nonzero(np.triu(topology.adjacency))
        return SparseTopology(topology.num_nodes, np.stack([i, j], axis=1))

    def to_dense(self) -> Topology:
        """The dense :class:`Topology` of the same edges (small N only)."""
        a = np.zeros((self.num_nodes, self.num_nodes), dtype=bool)
        rows = np.repeat(np.arange(self.num_nodes), self.degrees)
        a[rows, self.indices] = True
        return Topology(a)

    # -- queries ----------------------------------------------------------

    def get_peers(self, node_id: int) -> list[int]:
        lo, hi = int(self.indptr[node_id]), int(self.indptr[node_id + 1])
        return list(self.indices[lo:hi])

    def size(self, node: Optional[int] = None) -> int:
        if node is None:
            return self.num_nodes
        return int(self.degrees[node])

    @property
    def adjacency(self):
        raise AttributeError(
            "SparseTopology does not materialize a dense adjacency; use "
            "Topology for features that need one or from_dense/to_dense for "
            "small N")

    def sample_peers(self, generator: torch.Generator) -> torch.Tensor:
        """One uniform neighbour for every node under ``generator``, int32
        ``[N]`` on the host; -1 for an isolated node: a ``randint(degree)``
        into each CSR row, the engine's own draw
        (:meth:`~gossipy_tpu_torch.random.TorchDraws.csr_peers`). The same
        generator state gives the peers :meth:`Topology.sample_peers` gives
        over the dense adjacency of the same graph."""
        from .random import TorchDraws
        return TorchDraws(generator=generator).csr_peers(
            0, self.csr_on("cpu")).to(torch.int32)

    def csr_on(self, device: torch.device) -> CSR:
        """The neighbour lists on ``device``, copied once per device."""
        device = torch.device(device)
        csr = self._on.get(device)
        if csr is None:
            csr = self._on[device] = CSR(
                *(torch.as_tensor(a, device=device).long()
                  for a in (self.indptr, self.indices, self.degrees)))
        return csr


class SparseMixing(NamedTuple):
    """Mixing weights on the directed edges of a :class:`SparseTopology`,
    in its CSR order, O(E): ``edge_w[e]`` is ``W[rows[e], senders[e]]``
    and ``self_w[i]`` is ``W[i, i]``. The all-to-all merge is then a
    gather and a sum per receiver, with no ``[N, N]`` anywhere. Host-side
    numpy, as the dense matrix is; the simulator copies it to its
    device."""

    edge_w: np.ndarray    # [2E] float32, W[receiver, sender] per edge
    self_w: np.ndarray    # [N]  float32, W[i, i]
    rows: np.ndarray      # [2E] int32, the receiver (CSR row) per edge
    senders: np.ndarray   # [2E] int32, the sender (CSR index) per edge
    num_nodes: int


def _csr_edge_arrays(topo: SparseTopology):
    rows = np.repeat(np.arange(topo.num_nodes, dtype=np.int32),
                     np.asarray(topo.degrees))
    return rows, topo.indices


def uniform_mixing(topology):
    """Uniform mixing weights: row ``i`` weights node ``i`` and each of
    its ``deg(i)`` peers by ``1 / (deg(i) + 1)``. A :class:`Topology`
    gives the ``[N, N]`` float32 matrix, a :class:`SparseTopology` its
    :class:`SparseMixing` edge weights."""
    if isinstance(topology, SparseTopology):
        rows, senders = _csr_edge_arrays(topology)
        inv = 1.0 / (np.asarray(topology.degrees, dtype=np.float64) + 1.0)
        return SparseMixing(inv[rows].astype(np.float32),
                            inv.astype(np.float32), rows, senders,
                            topology.num_nodes)
    a = topology.adjacency.astype(np.float64)
    deg = a.sum(axis=1)
    w = a / (deg[:, None] + 1.0)
    np.fill_diagonal(w, 1.0 / (deg + 1.0))
    return w.astype(np.float32)


def metropolis_hastings_mixing(topology):
    """The standard Metropolis-Hastings weights (symmetric, doubly
    stochastic): ``W_ij = 1 / (1 + max(deg_i, deg_j))`` on edges, ``W_ii
    = 1 - sum_j W_ij``; the JAX package's weights, not the original
    gossipy's. ``[N, N]`` float32 over a :class:`Topology`,
    :class:`SparseMixing` over a :class:`SparseTopology`."""
    if isinstance(topology, SparseTopology):
        rows, senders = _csr_edge_arrays(topology)
        deg = np.asarray(topology.degrees, dtype=np.float64)
        ew = 1.0 / (1.0 + np.maximum(deg[rows], deg[senders]))
        self_w = 1.0 - np.bincount(rows, weights=ew,
                                   minlength=topology.num_nodes)
        return SparseMixing(ew.astype(np.float32),
                            self_w.astype(np.float32), rows, senders,
                            topology.num_nodes)
    a = topology.adjacency.astype(np.float64)
    deg = a.sum(axis=1)
    w = a / (1.0 + np.maximum(deg[:, None], deg[None, :]))
    np.fill_diagonal(w, 0.0)
    np.fill_diagonal(w, 1.0 - w.sum(axis=1))
    return w.astype(np.float32)


def mixing_weight_rows(w: np.ndarray, topology: Topology) -> np.ndarray:
    """Per-node weight vectors ``[N, max_deg + 1]`` float32 in the original
    gossipy's layout, ``[self weight, peer weights in id order...]``,
    zero-padded. Dense only, as in the JAX package: a
    :class:`SparseTopology`'s ``adjacency`` raises."""
    n = topology.num_nodes
    max_deg = int(topology.degrees.max()) if n else 0
    out = np.zeros((n, max_deg + 1), dtype=np.float32)
    w = np.asarray(w)
    for i in range(n):
        peers = np.where(topology.adjacency[i])[0]
        out[i, 0] = w[i, i]
        out[i, 1:1 + len(peers)] = w[i, peers]
    return out


@dataclasses.dataclass(frozen=True)
class Delay:
    """Base message-latency model: ``sample`` returns ``[n]`` int64 delays
    in simulation time units for messages of ``size`` scalars, drawing any
    randomness from the simulation's draw provider under ``(r, purpose,
    sub)``."""

    def max_delay(self, size: int) -> int:
        raise NotImplementedError

    def sample(self, draws, r: int, purpose: int, n: int, size: int,
               device: torch.device, sub: int = 0) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ConstantDelay(Delay):
    """Fixed delay."""

    delay: int = 0

    def max_delay(self, size: int) -> int:
        return self.delay

    def sample(self, draws, r, purpose, n, size, device, sub=0):
        return torch.full((n,), self.delay, dtype=torch.int64, device=device)


@dataclasses.dataclass(frozen=True)
class UniformDelay(Delay):
    """Uniform integer delay in ``[min_delay, max_delay_]``."""

    min_delay: int
    max_delay_: int

    def __post_init__(self):
        if not 0 <= self.min_delay <= self.max_delay_:
            raise ValueError("need 0 <= min_delay <= max_delay_")

    def max_delay(self, size: int) -> int:
        return self.max_delay_

    def sample(self, draws, r, purpose, n, size, device, sub=0):
        return draws.randint(r, purpose, self.min_delay, self.max_delay_, n,
                             device, sub)


@dataclasses.dataclass(frozen=True)
class LinearDelay(Delay):
    """Overhead plus a size-proportional delay,
    ``int(timexunit * size) + overhead``: the same for every message of
    one size."""

    timexunit: float
    overhead: int

    def max_delay(self, size: int) -> int:
        return int(self.timexunit * size) + self.overhead

    def sample(self, draws, r, purpose, n, size, device, sub=0):
        return torch.full((n,), self.max_delay(size), dtype=torch.int64,
                          device=device)
