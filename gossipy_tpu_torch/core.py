"""Core protocol primitives: enums, the dense topology, delay models.

Counterpart of ``gossipy_tpu/core.py``. The topology is a host-side numpy
bool adjacency; the simulator copies it to its device once. Peer draws go
through the simulation's :class:`~gossipy_tpu_torch.random.DrawProvider`.

Ported so far: the enums, :class:`Topology` with its ``clique``
constructor, and :class:`ConstantDelay`. The other constructors, the
sparse topology and the random delay models are still to be ported.
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum

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

    def adjacency_on(self, device: torch.device) -> torch.Tensor:
        """The adjacency as a bool tensor on ``device``."""
        return torch.as_tensor(self.adjacency, device=device)


@dataclasses.dataclass(frozen=True)
class Delay:
    """Base message-latency model: ``sample`` returns integer delays in
    simulation time units for a batch of messages of ``size`` scalars."""

    def max_delay(self, size: int) -> int:
        raise NotImplementedError

    def sample(self, n: int, size: int, device: torch.device) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ConstantDelay(Delay):
    """Fixed delay."""

    delay: int = 0

    def max_delay(self, size: int) -> int:
        return self.delay

    def sample(self, n, size, device):
        return torch.full((n,), self.delay, dtype=torch.int64, device=device)
