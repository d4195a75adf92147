"""Core protocol primitives: enums, the dense topology, delay models.

Counterpart of ``gossipy_tpu/core.py``. The topology is a host-side numpy
bool adjacency; the simulator copies it to its device once. Peer draws and
random delays go through the simulation's
:class:`~gossipy_tpu_torch.random.DrawProvider`.

Ported so far: the enums, :class:`Topology` with its ``clique``, ``ring``,
``random_regular`` and ``barabasi_albert`` constructors (the last two with
networkx's algorithms, copied below, so the edge set equals the JAX
package's for every seed), the dense mixing matrices of the all-to-all
simulator and the three delay models. ``erdos_renyi``, the native
generators, the sparse topology and the sparse mixing are still to be
ported.
"""

from __future__ import annotations

import dataclasses
import random
from collections import defaultdict
from enum import IntEnum
from typing import Optional

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
    def random_regular(n: int, degree: int, seed: int = 42,
                       backend: str = "auto") -> "Topology":
        """Random ``degree``-regular graph on ``n`` nodes, with the edge set
        networkx's ``random_regular_graph(degree, n, seed)`` gives (the JAX
        package's ``backend="networkx"``). The default ``"auto"`` is the
        JAX package's: networkx's algorithm below ``NATIVE_THRESHOLD``
        nodes, the C++ generator from there on. ``"native"``, and
        ``"auto"`` at ``n >= NATIVE_THRESHOLD``, name that generator, which
        is not ported yet: they raise, so the same call never gives the
        two packages different edge sets."""
        Topology._check_backend(n, backend)
        a = np.zeros((n, n), dtype=bool)
        for s1, s2 in _random_regular_edges(degree, n, random.Random(seed)):
            a[s1, s2] = a[s2, s1] = True
        return Topology(a)

    @staticmethod
    def barabasi_albert(n: int, m: int, seed: int = 42,
                        backend: str = "auto") -> "Topology":
        """Preferential-attachment graph on ``n`` nodes, ``m`` edges from
        each new node, with the edge set networkx's
        ``barabasi_albert_graph(n, m, seed)`` gives. ``"native"``, and
        ``"auto"`` at ``n >= NATIVE_THRESHOLD``, raise as in
        :meth:`random_regular`."""
        Topology._check_backend(n, backend)
        a = np.zeros((n, n), dtype=bool)
        for s1, s2 in _barabasi_albert_edges(n, m, random.Random(seed)):
            a[s1, s2] = a[s2, s1] = True
        return Topology(a)

    @staticmethod
    def _check_backend(n: int, backend: str) -> None:
        if backend not in ("auto", "networkx", "native"):
            raise ValueError("backend must be 'auto', 'networkx' or "
                             f"'native', got {backend!r}")
        if backend == "native" or (backend == "auto"
                                   and n >= Topology.NATIVE_THRESHOLD):
            raise NotImplementedError(
                "the native graph generators are not ported yet (backend="
                f"{backend!r} at n={n}, threshold "
                f"{Topology.NATIVE_THRESHOLD}); pass backend='networkx'")

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


# The pairing algorithm of networkx 3.6.1's ``random_regular_graph``
# (networkx/generators/random_graphs.py:524) and its preferential
# attachment, ``barabasi_albert_graph`` with ``_random_subset`` (the same
# file), copied so that the port needs no networkx. Their only randomness
# is ``rng.shuffle`` of the stubs and ``rng.choice`` of the repeated-node
# list, with ``rng = random.Random(seed)`` as networkx's
# ``py_random_state`` makes it.
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


def uniform_mixing(topology: Topology) -> np.ndarray:
    """Uniform mixing weights ``[N, N]`` float32: row ``i`` weights node
    ``i`` and each of its ``deg(i)`` peers by ``1 / (deg(i) + 1)``
    (``gossipy_tpu/core.py::uniform_mixing``, dense only)."""
    _dense_only(topology)
    a = topology.adjacency.astype(np.float64)
    deg = a.sum(axis=1)
    w = a / (deg[:, None] + 1.0)
    np.fill_diagonal(w, 1.0 / (deg + 1.0))
    return w.astype(np.float32)


def metropolis_hastings_mixing(topology: Topology) -> np.ndarray:
    """The standard Metropolis-Hastings weights ``[N, N]`` float32
    (symmetric, doubly stochastic): ``W_ij = 1 / (1 + max(deg_i,
    deg_j))`` on edges, ``W_ii = 1 - sum_j W_ij``; the JAX package's
    weights, not the original gossipy's (dense only)."""
    _dense_only(topology)
    a = topology.adjacency.astype(np.float64)
    deg = a.sum(axis=1)
    w = a / (1.0 + np.maximum(deg[:, None], deg[None, :]))
    np.fill_diagonal(w, 0.0)
    np.fill_diagonal(w, 1.0 - w.sum(axis=1))
    return w.astype(np.float32)


def mixing_weight_rows(w: np.ndarray, topology: Topology) -> np.ndarray:
    """Per-node weight vectors ``[N, max_deg + 1]`` float32 in the original
    gossipy's layout, ``[self weight, peer weights in id order...]``,
    zero-padded."""
    _dense_only(topology)
    n = topology.num_nodes
    max_deg = int(topology.degrees.max()) if n else 0
    out = np.zeros((n, max_deg + 1), dtype=np.float32)
    w = np.asarray(w)
    for i in range(n):
        peers = np.where(topology.adjacency[i])[0]
        out[i, 0] = w[i, i]
        out[i, 1:1 + len(peers)] = w[i, peers]
    return out


def _dense_only(topology) -> None:
    if not isinstance(topology, Topology):
        raise NotImplementedError(
            f"{type(topology).__name__} mixing is not ported yet (the dense "
            "Topology only)")


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
