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
(:meth:`DrawProvider.peers`, :meth:`DrawProvider.csr_peers`,
:meth:`DrawProvider.slot_peers`, :meth:`DrawProvider.uniform`,
:meth:`DrawProvider.choice`) from the base ``_round_key(r, K_FIRE)``
folded with ``f``.

The sequential engine (:mod:`~gossipy_tpu_torch.simulation.sequential`)
draws by event, not by round: the JAX engine seeds two host generators
from ``split(key)[0]`` (:meth:`DrawProvider.seq_host_seeds`) and takes
every other draw from ``fold_in(split(key)[1], e)``, ``e`` one counter
that every handler call, delay sample and token reaction advances
(:meth:`DrawProvider.event_orders`, :meth:`DrawProvider.event_randint`,
:meth:`DrawProvider.event_uniform`). Its ``init_nodes`` keys node ``i``'s
pre-training on ``fold_in(k_up, i)``
(:meth:`DrawProvider.seq_init_permutations`) and its phases on one host
seed (:meth:`DrawProvider.seq_init_seed`).

A uniform peer is drawn in the topology's form, as the JAX package draws
it: a categorical over a dense adjacency row (:meth:`DrawProvider.peers`),
a ``randint`` into a sparse topology's CSR row
(:meth:`DrawProvider.csr_peers`), and under sparse chaos a categorical
over the alive slots of the padded neighbour table
(:meth:`DrawProvider.slot_peers`).

Active-cohort rounds (:mod:`~gossipy_tpu_torch.simulation.cohort`) draw a
peer over the C materialized nodes with no ``[C, C]`` clique
(:meth:`DrawProvider.cohort_peers`, ``(i + 1 + randint(0, C - 1)) % C``)
and sample their cohorts from seed material
(:meth:`DrawProvider.cohort_seed_material`), never from a provider's
stream: a prefetch thread samples ahead of the rounds.

The simulator variants draw under the JAX package's variant tags
(``>= 9000``): the token gate ``K_TOKEN_GATE``, reactive rounding
``K_REACT_SLOT + k``, the reaction waves ``K_REACT_PEER``, ``_DROP``,
``_DELAY``, ``_EXTRA`` each ``+ 10 j``, the all-to-all round's drops,
online draws and updates, and the neighbour cache's pop and merge.
"""

from __future__ import annotations

from typing import Optional, Sequence

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

    def csr_peers(self, r: int, csr, sub: int = 0, purpose: int = K_PEER,
                  fold: int = 0) -> torch.Tensor:
        """One uniform neighbour per node of a sparse topology's
        neighbour lists ``csr`` (:class:`~gossipy_tpu_torch.core.CSR`):
        the JAX ``SparseTopology.sample_peers``, ``randint(key, (n,), 0,
        max(deg, 1))`` into the row, not the dense categorical; keys as in
        :meth:`peers`; ``-1`` for a node with no neighbour."""
        raise NotImplementedError

    def slot_peers(self, r: int, nbr: torch.Tensor, alive: torch.Tensor,
                   sub: int = 0, purpose: int = K_PEER) -> torch.Tensor:
        """One uniform neighbour per node among its alive slots: ``nbr``
        is the padded neighbour table ``[n, max_deg]`` (``-1``: no
        slot), ``alive`` the bool mask of the slots a draw may take (the
        sparse chaos form). The slot is the JAX ``categorical`` over ``0 /
        -inf`` logits, drawn as :meth:`choice` draws it; ``-1`` for a
        node with no alive slot."""
        slot = self.choice(r, purpose, alive, sub).clamp(0, nbr.shape[1] - 1)
        peers = nbr.gather(1, slot[:, None]).squeeze(1).long()
        return torch.where(alive.any(dim=1), peers, -1)

    def cohort_peers(self, r: int, c: int, device: torch.device,
                     sub: int = 0, purpose: int = K_PEER) -> torch.Tensor:
        """One uniform peer other than itself for each of ``c`` cohort
        nodes, ``(i + 1 + u_i) % c`` with ``u_i`` a uniform integer in
        ``[0, c - 2]`` (the JAX ``_CohortRoundTopology.sample_peers``: no
        ``[c, c]`` clique), int64 on ``device``; keys as in
        :meth:`peers`."""
        raise NotImplementedError

    def cohort_seed_material(self) -> list:
        """The integers a cohort schedule is seeded from
        (``simulation.cohort.sample_cohort``): a pure function of the
        provider, never a draw from its stream, so that cohorts sampled
        ahead of the rounds leave every round's draws as they are."""
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

    def get_state(self) -> Optional[dict]:
        """What a checkpoint must keep for a run to continue with the same
        draws: None for a provider keyed on the round and the purpose (the
        JAX engine's keys, the oracle), whose draws need no state; a
        stream provider gives its stream's state (:class:`TorchDraws`)."""
        return None

    def set_state(self, state: Optional[dict]) -> None:
        """Resume from a :meth:`get_state` result."""
        if state is not None:
            raise ValueError(f"{type(self).__name__} keeps no draw state")

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

    # -- the sequential engine's draws, by event --------------------------

    def seq_init_seed(self) -> int:
        """The seed of the host generator the sequential ``init_nodes``
        draws its send offsets (or periods) from."""
        raise NotImplementedError

    def seq_init_permutations(self, n: int, epochs: int, s: int,
                              device: torch.device) -> torch.Tensor:
        """The sequential ``init_nodes``' pre-training orders, ``[n,
        max(epochs, 1), s]`` as :meth:`init_permutations` gives them, node
        ``i``'s drawn from its own key (the JAX ``fold_in(k_up, i)``)."""
        raise NotImplementedError

    def seq_host_seeds(self) -> tuple[int, int]:
        """The seeds of a sequential run's two host generators: the
        scheduling one (orders, peers, drops, online draws, token gates,
        sampled evaluation) and the variants' (accept draws, cache
        pops)."""
        raise NotImplementedError

    def event_orders(self, e: int, epochs: int, s: int,
                     split: bool = False) -> torch.Tensor:
        """Event ``e``'s shard orders for one node's update, ``[1,
        max(epochs, 1), s]`` (``split``: ``[1, 2 max(epochs, 1), s]``, the
        two halves of the UPDATE_MERGE ``call``), on the CPU."""
        raise NotImplementedError

    def event_randint(self, e: int, lo: int, hi: int) -> int:
        """Event ``e``'s integer uniform in ``[lo, hi]`` (a delay)."""
        raise NotImplementedError

    def event_uniform(self, e: int) -> float:
        """Event ``e``'s float32 uniform in ``[0, 1)`` (a token
        reaction's rounding)."""
        raise NotImplementedError


class TorchDraws(DrawProvider):
    """The default provider: one seeded CPU ``torch.Generator``.

    Draws are made on the host and copied to the run's device, so the same
    seed gives the same draws on the CPU and on the card (a run on each can
    then be held against the other). The values are few (``[n]`` masks and
    peers, ``[n, epochs, s]`` shard orders), so the copy is small.

    The draws are one stream: they do not depend on the round, so a run
    continues with the same draws only from the generator's state, which
    a checkpoint keeps (:meth:`get_state`, :meth:`set_state`).
    """

    def __init__(self, seed: int = 42,
                 generator: Optional[torch.Generator] = None):
        """A generator seeded with ``seed``, or the caller's CPU
        ``generator`` itself (its seed is then its ``initial_seed()``)."""
        if generator is not None:
            self.seed = int(generator.initial_seed())
            self.generator = generator
        else:
            self.seed = int(seed)
            self.generator = torch.Generator().manual_seed(seed)
        # id(adjacency) -> (adjacency, degrees, row starts, ids): one entry
        # per dense adjacency tensor a run draws over (the topology's, and
        # under chaos one per distinct edge-alive mask), kept for the
        # provider's life so that alternating between them copies nothing.
        # A sparse topology's neighbour lists are its CSR arrays already.
        self._neighbours: dict = {}

    def get_state(self) -> dict:
        """The generator's state (a uint8 tensor, a copy) and the seed
        (the cohort schedule's material)."""
        return {"generator": self.generator.get_state(), "seed": self.seed}

    def set_state(self, state) -> None:
        # A checkpoint read onto the card holds the state on the card.
        self.generator.set_state(state["generator"].cpu())
        self.seed = int(state.get("seed", self.seed))

    def _perms(self, n: int, epochs: int, s: int) -> torch.Tensor:
        u = torch.rand((n, max(epochs, 1), s), generator=self.generator)
        return torch.argsort(u, dim=-1)

    def _orders(self, n: int, epochs: int, s: int, split: bool
                ) -> torch.Tensor:
        """:meth:`_perms`, or with ``split`` two of them side by side."""
        if split:
            return torch.cat([self._perms(n, epochs, s) for _ in range(2)],
                             dim=1)
        return self._perms(n, epochs, s)

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
        cached = self._neighbours.get(id(adjacency))
        if cached is None or cached[0] is not adjacency:
            adj = adjacency.cpu()
            deg = adj.sum(dim=1)
            starts = torch.cumsum(deg, 0) - deg
            ids = adj.nonzero()[:, 1].to(torch.int32)
            cached = (adjacency, deg, starts, ids)
            self._neighbours[id(adjacency)] = cached
        return cached[1:]

    def peers(self, r, adjacency, sub=0, purpose=K_PEER, fold=0):
        """Node ``i`` takes its ``floor(u_i deg_i)``-th neighbour in index
        order, ``u_i`` uniform in ``[0, 1)`` (float64): one ``[n]`` draw
        and a gather, whatever the degree."""
        deg, starts, ids = self._neighbour_lists(adjacency)
        u = torch.rand(deg.shape, generator=self.generator,
                       dtype=torch.float64)
        has_peer = deg > 0
        # The neighbour lists are host tensors: no sync.
        if not bool(has_peer.any()):  # tracelint: disable=host-sync
            return torch.full(deg.shape, -1, dtype=torch.int64,
                              device=adjacency.device)
        k = torch.minimum((u * deg).to(torch.int64), deg - 1).clamp(min=0)
        peers = ids[torch.where(has_peer, starts + k, 0)].to(torch.int64)
        return torch.where(has_peer, peers, -1).to(adjacency.device)

    def csr_peers(self, r, csr, sub=0, purpose=K_PEER, fold=0):
        """:meth:`peers`' rule over the CSR rows, on their device: the
        same draws give the same peers as :meth:`peers` over the dense
        adjacency of the same graph."""
        deg = csr.degrees
        u = torch.rand(deg.shape, generator=self.generator,
                       dtype=torch.float64).to(deg.device)
        if csr.indices.numel() == 0:      # a graph with no edge at all
            return torch.full_like(deg, -1)
        has_peer = deg > 0
        k = torch.minimum((u * deg).to(torch.int64), deg - 1).clamp(min=0)
        pos = torch.where(has_peer, csr.indptr[:-1] + k, 0)
        return torch.where(has_peer, csr.indices[pos], -1)

    def cohort_peers(self, r, c, device, sub=0, purpose=K_PEER):
        u = torch.randint(0, c - 1, (c,), generator=self.generator,
                          dtype=torch.int64)
        return ((torch.arange(c) + 1 + u) % c).to(device)

    def cohort_seed_material(self):
        """The seed, as two 32-bit words."""
        return [self.seed & 0xFFFFFFFF, (self.seed >> 32) & 0xFFFFFFFF]

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
        return self._orders(first_k.shape[0], epochs, s, split).to(
            first_k.device)

    def seq_init_seed(self):
        return int(torch.randint(0, 2 ** 31 - 1, (1,),
                                 generator=self.generator))

    seq_init_permutations = init_permutations

    def seq_host_seeds(self):
        a, b = torch.randint(0, 2 ** 31 - 1, (2,),
                             generator=self.generator).tolist()
        return int(a), int(b)

    def event_orders(self, e, epochs, s, split=False):
        return self._orders(1, epochs, s, split)

    def event_randint(self, e, lo, hi):
        return int(torch.randint(lo, hi + 1, (1,), generator=self.generator))

    def event_uniform(self, e):
        return float(torch.rand((1,), generator=self.generator))
