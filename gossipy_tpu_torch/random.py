"""The draw seam: every random number a simulation consumes comes from here.

The JAX engine derives each draw from a threefry key,
``fold_in(fold_in(base, round), purpose)`` (``GossipSimulator._round_key``),
with one purpose tag per kind of draw (``_K_*``). ``torch.Generator``'s
Philox streams cannot reproduce those bits, so the engine never draws
directly: it asks a :class:`DrawProvider` for exactly the values it needs,
by round and purpose. :class:`TorchDraws` is the default provider. A test
provider that replays the JAX engine's keys (``tests/torch_oracle.py``)
makes a port run match a reference run draw for draw.
"""

from __future__ import annotations

from typing import Sequence

import torch

# Purpose tags, value for value those of the JAX engine (one stream per
# (round, purpose)); the engine derives per-slot tags as ``tag * 101 + k``.
K_PHASE, K_PEER, K_DROP, K_DELAY, K_ONLINE, K_CALL, K_EXTRA, \
    K_REPLY_DELAY, K_REPLY_DROP, K_EVAL, K_TOKEN, K_FIRE = range(12)


class DrawProvider:
    """What a simulation draws, by round and purpose.

    Every method returns a tensor on ``device``. Index tensors are int64,
    masks bool.
    """

    def init_phase(self, n: int, delta: int,
                   device: torch.device) -> torch.Tensor:
        """Sync send offsets: ``[n]`` uniform integers in ``[0, delta)``."""
        raise NotImplementedError

    def init_permutations(self, n: int, epochs: int, s: int,
                          device: torch.device) -> torch.Tensor:
        """Per-node, per-epoch shard orders for the pre-training pass:
        ``[n, epochs, s]``, each row a permutation of ``range(s)``."""
        raise NotImplementedError

    def peers(self, r: int, adjacency: torch.Tensor) -> torch.Tensor:
        """One uniform neighbour per node of the bool ``[n, n]`` adjacency
        (purpose ``K_PEER``); ``-1`` for a node with no neighbour."""
        raise NotImplementedError

    def bernoulli(self, r: int, purpose: int, p: float, n: int,
                  device: torch.device) -> torch.Tensor:
        """``[n]`` independent draws that are True with probability ``p``."""
        raise NotImplementedError

    def update_permutations(self, r: int, purposes: Sequence[int],
                            first_k: torch.Tensor, epochs: int, s: int
                            ) -> torch.Tensor:
        """Shard orders ``[n, epochs, s]`` for the round's local update.

        ``purposes[k]`` is the stream of mailbox slot ``k`` and
        ``first_k[i]`` the first live slot of node ``i``: node ``i`` trains
        under slot ``first_k[i]``'s stream, as the JAX engine's
        ``_fused_slot_keys`` selects it. The result lies on
        ``first_k``'s device.
        """
        raise NotImplementedError


class TorchDraws(DrawProvider):
    """The default provider: one seeded CPU ``torch.Generator``.

    Draws are made on the host and copied to the run's device, so the same
    seed gives the same draws on the CPU and on the card (a run on each can
    then be held against the other). The values are few (``[n]`` masks and
    peers, ``[n, epochs, s]`` shard orders), so the copy is small.
    """

    def __init__(self, seed: int = 42):
        self.generator = torch.Generator().manual_seed(seed)

    def _perms(self, n: int, epochs: int, s: int) -> torch.Tensor:
        u = torch.rand((n, epochs, s), generator=self.generator)
        return torch.argsort(u, dim=-1)

    def init_phase(self, n, delta, device):
        return torch.randint(0, delta, (n,), generator=self.generator,
                             dtype=torch.int32).to(device)

    def init_permutations(self, n, epochs, s, device):
        return self._perms(n, epochs, s).to(device)

    def peers(self, r, adjacency):
        adj = adjacency.cpu()
        has_peer = adj.any(dim=1)
        # multinomial refuses an all-zero row: give isolated nodes a dummy
        # weight and mask their draw to -1 afterwards.
        w = adj.to(torch.float32)
        w[~has_peer, 0] = 1.0
        peers = torch.multinomial(w, 1, generator=self.generator)[:, 0]
        return torch.where(has_peer, peers, -1).to(adjacency.device)

    def bernoulli(self, r, purpose, p, n, device):
        u = torch.rand((n,), generator=self.generator)
        return (u < p).to(device)

    def update_permutations(self, r, purposes, first_k, epochs, s):
        return self._perms(first_k.shape[0], epochs, s).to(first_k.device)
