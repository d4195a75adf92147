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
purpose key of :meth:`DrawProvider.bernoulli` and
:meth:`DrawProvider.randint`, and derives the draws of its send hooks
(:meth:`DrawProvider.peers`, :meth:`DrawProvider.uniform`,
:meth:`DrawProvider.choice`) from the base ``_round_key(r, K_FIRE)``
folded with ``f``.

The simulator variants draw under the JAX package's variant tags
(``>= 9000``): the token gate ``K_TOKEN_GATE``, reactive rounding
``K_REACT_SLOT + k``, the reaction waves ``K_REACT_PEER``, ``_DROP``,
``_DELAY``, ``_EXTRA`` each ``+ 10 j``, the all-to-all round's drops,
online draws and updates, and the neighbour cache's pop and merge.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .compression import sample_mask as _hash_mask

# Purpose tags, value for value those of the JAX engine (one stream per
# (round, purpose)); the engine derives per-slot tags as ``tag * 101 + k``.
K_PHASE, K_PEER, K_DROP, K_DELAY, K_ONLINE, K_CALL, K_EXTRA, \
    K_REPLY_DELAY, K_REPLY_DROP, K_EVAL, K_TOKEN, K_FIRE = range(12)
# The variants' tags (gossipy_tpu/simulation/variants.py, nodes.py).
K_TOKEN_GATE = 9000
K_REACT_SLOT = 9100
K_REACT_PEER, K_REACT_DROP, K_REACT_DELAY, K_REACT_EXTRA = 9200, 9201, \
    9202, 9203
K_A2A_DROP, K_A2A_ONLINE, K_A2A_UPDATE = 9400, 9401, 9402
K_CACHE_POP, K_CACHE_MERGE = 9500, 9501
# A pass-through receive draws its accept under ``fold_in(row key, 911)``;
# PENS draws its fallback peer under ``fold_in(peer key, 3)``.
FOLD_ACCEPT = 911
FOLD_FALLBACK = 3


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

    def peers(self, r: int, adjacency: torch.Tensor, sub: int = 0,
              purpose: int = K_PEER, fold: int = 0) -> torch.Tensor:
        """One uniform neighbour per node of the bool ``[n, n]`` adjacency
        (purpose ``K_PEER`` unless named; ``fold`` folds a tag into the
        key); ``-1`` for a node with no neighbour."""
        raise NotImplementedError

    def bernoulli(self, r: int, purpose: int, p: float, n, device:
                  torch.device, sub: int = 0) -> torch.Tensor:
        """Independent draws that are True with probability ``p``, of
        shape ``[n]`` (or ``n`` when it is a tuple)."""
        raise NotImplementedError

    def uniform(self, r: int, purpose: int, n: int, device: torch.device,
                sub: int = 0) -> torch.Tensor:
        """``[n]`` float32 uniform in ``[0, 1)``; ``u < p`` is the JAX
        ``bernoulli(key, p)`` of a per-node ``p``."""
        raise NotImplementedError

    def choice(self, r: int, purpose: int, valid: torch.Tensor,
               sub: int = 0) -> torch.Tensor:
        """Per row of the bool ``[n, s]`` ``valid``, the index of one of
        its True entries drawn uniformly (the JAX ``categorical`` over
        ``0 / -inf`` logits), int64 on ``valid``'s device; 0 for a row
        with none."""
        raise NotImplementedError

    def row_uniform(self, r: int, purpose: int, n: int, fold: int,
                    device: torch.device) -> torch.Tensor:
        """``[n]`` float32 uniform, row ``i`` drawn from the key of node
        ``i``'s stream under ``purpose`` (the per-node key a receive
        trains under) folded with ``fold``."""
        raise NotImplementedError

    def sample_mask(self, payload: torch.Tensor, layout,
                    sample_size: float) -> torch.Tensor:
        """The sampled merge's ``[rows, stride]`` bool coordinate mask of
        each row's 31-bit ``payload`` (padding columns False)."""
        raise NotImplementedError

    def derive(self, tag: int) -> "DrawProvider":
        """The provider of a run segment keyed on ``tag`` (PENS's second
        phase runs under the JAX base key ``fold_in(key, 2)``); a stream
        provider carries on as it is."""
        return self

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

    def peers(self, r, adjacency, sub=0, purpose=K_PEER, fold=0):
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
        shape = (n,) if isinstance(n, int) else tuple(n)
        u = torch.rand(shape, generator=self.generator)
        return (u < p).to(device)

    def uniform(self, r, purpose, n, device, sub=0):
        return torch.rand((n,), generator=self.generator).to(device)

    def choice(self, r, purpose, valid, sub=0):
        """The ``floor(u count)``-th True entry of each row, ``u`` uniform
        (float64): one ``[n]`` draw whatever the row length."""
        u = torch.rand(valid.shape[0], generator=self.generator,
                       dtype=torch.float64).to(valid.device)
        count = valid.sum(dim=1)
        k = torch.minimum((u * count).to(torch.int64), count - 1)
        hit = valid & (valid.cumsum(dim=1) == (k + 1)[:, None])
        return hit.to(torch.int8).argmax(dim=1)

    def row_uniform(self, r, purpose, n, fold, device):
        return torch.rand((n,), generator=self.generator).to(device)

    def sample_mask(self, payload, layout, sample_size):
        return _hash_mask(payload, layout, sample_size)

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
