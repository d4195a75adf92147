"""The draw seam: every random number a simulation consumes comes from here.

The JAX engine derives each draw from a threefry key,
``fold_in(fold_in(base, round), purpose)`` (``GossipSimulator._round_key``),
with one purpose tag per kind of draw (``_K_*``). ``torch.Generator``'s
Philox streams cannot reproduce those bits, so the engine never draws
directly: it asks a :class:`DrawProvider` for exactly the values it needs,
by round and purpose. :class:`TorchDraws` is the default provider. A test
provider that replays the JAX engine's keys (``tests/torch_oracle.py``)
makes a port run match a reference run draw for draw.

Sub-fires: an async node may send ``F`` times in one round. Sub-fire
``f > 0`` draws under ``sub=f``: the JAX engine folds ``f`` into each
purpose key, and draws its peers from the base ``_round_key(r, K_FIRE)``
folded with ``f``.
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
        ``[n, max(epochs, 1), s]``, each row a permutation of
        ``range(s)`` (``epochs=0``: the one order a handler that takes a
        single step draws straight from the node's key)."""
        raise NotImplementedError

    def init_period(self, n: int, delta: int,
                    device: torch.device) -> torch.Tensor:
        """Async send periods: ``[n]`` int32
        ``max(int(delta + delta / 10 * z), 1)`` with ``z`` standard
        normal."""
        raise NotImplementedError

    def peers(self, r: int, adjacency: torch.Tensor,
              sub: int = 0) -> torch.Tensor:
        """One uniform neighbour per node of the bool ``[n, n]`` adjacency
        (purpose ``K_PEER``); ``-1`` for a node with no neighbour."""
        raise NotImplementedError

    def bernoulli(self, r: int, purpose: int, p: float, n: int,
                  device: torch.device, sub: int = 0) -> torch.Tensor:
        """``[n]`` independent draws that are True with probability ``p``."""
        raise NotImplementedError

    def randint(self, r: int, purpose: int, lo: int, hi: int, n: int,
                device: torch.device, sub: int = 0) -> torch.Tensor:
        """``[n]`` int64 uniform integers in ``[lo, hi]`` (random
        delays)."""
        raise NotImplementedError

    def eval_subset(self, r: int, n: int, n_pick: int,
                    device: torch.device) -> torch.Tensor:
        """The ``n_pick`` nodes a sampled evaluation reads (purpose
        ``K_EVAL``): the first ``n_pick`` of a random permutation of
        ``range(n)``, int64."""
        raise NotImplementedError

    def update_permutations(self, r: int, purposes: Sequence[int],
                            first_k: torch.Tensor, epochs: int, s: int,
                            split: bool = False) -> torch.Tensor:
        """Shard orders ``[n, E, s]`` for the round's local update, ``E =
        max(epochs, 1)`` as in :meth:`init_permutations`.

        ``purposes[k]`` is the stream of mailbox slot ``k`` and
        ``first_k[i]`` the first live slot of node ``i``: node ``i`` trains
        under slot ``first_k[i]``'s stream, as the JAX engine's
        ``_fused_slot_keys`` selects it. ``split`` gives ``[n, 2 E, s]``:
        the orders of the two halves of each node's stream (the JAX
        UPDATE_MERGE ``call`` splits the node's key and trains one model
        under each), first half first. The result lies on ``first_k``'s
        device.
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
        self._neighbours = None   # (adjacency, degrees, row starts, ids)

    def _perms(self, n: int, epochs: int, s: int) -> torch.Tensor:
        u = torch.rand((n, max(epochs, 1), s), generator=self.generator)
        return torch.argsort(u, dim=-1)

    def init_phase(self, n, delta, device):
        return torch.randint(0, delta, (n,), generator=self.generator,
                             dtype=torch.int32).to(device)

    def init_permutations(self, n, epochs, s, device):
        return self._perms(n, epochs, s).to(device)

    def init_period(self, n, delta, device):
        z = torch.randn((n,), generator=self.generator)
        raw = delta + (delta / 10.0) * z
        return torch.clamp(raw.to(torch.int32), min=1).to(device)

    def _neighbour_lists(self, adjacency: torch.Tensor):
        """The adjacency's neighbour lists on the host, ``(degrees, row
        starts, neighbour ids)``, made once per adjacency tensor."""
        cached = self._neighbours
        if cached is None or cached[0] is not adjacency:
            adj = adjacency.cpu()
            deg = adj.sum(dim=1)
            starts = torch.cumsum(deg, 0) - deg
            ids = adj.nonzero()[:, 1].to(torch.int32)
            cached = (adjacency, deg, starts, ids)
            self._neighbours = cached
        return cached[1:]

    def peers(self, r, adjacency, sub=0):
        """Node ``i`` takes its ``floor(u_i deg_i)``-th neighbour in index
        order, ``u_i`` uniform in ``[0, 1)`` (float64): one ``[n]`` draw
        and a gather, whatever the degree."""
        deg, starts, ids = self._neighbour_lists(adjacency)
        u = torch.rand(deg.shape, generator=self.generator,
                       dtype=torch.float64)
        has_peer = deg > 0
        if not bool(has_peer.any()):
            return torch.full(deg.shape, -1, dtype=torch.int64,
                              device=adjacency.device)
        k = torch.minimum((u * deg).to(torch.int64), deg - 1).clamp(min=0)
        peers = ids[torch.where(has_peer, starts + k, 0)].to(torch.int64)
        return torch.where(has_peer, peers, -1).to(adjacency.device)

    def bernoulli(self, r, purpose, p, n, device, sub=0):
        u = torch.rand((n,), generator=self.generator)
        return (u < p).to(device)

    def randint(self, r, purpose, lo, hi, n, device, sub=0):
        return torch.randint(lo, hi + 1, (n,), generator=self.generator,
                             dtype=torch.int64).to(device)

    def eval_subset(self, r, n, n_pick, device):
        return torch.randperm(n, generator=self.generator)[:n_pick].to(device)

    def update_permutations(self, r, purposes, first_k, epochs, s,
                            split=False):
        n = first_k.shape[0]
        if split:
            both = [self._perms(n, epochs, s) for _ in range(2)]
            return torch.cat(both, dim=1).to(first_k.device)
        return self._perms(n, epochs, s).to(first_k.device)
