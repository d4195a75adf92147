"""Node-behaviour simulator variants.

Counterpart of ``gossipy_tpu/simulation/nodes.py``: each protocol variant
of the original gossipy's node classes is a :class:`GossipSimulator`
subclass overriding the engine's hooks, its per-node state in
``state.aux`` (leading node axis), updated in place.

- :class:`PassThroughGossipSimulator` (Giaretta 2019): a message carries
  its sender's degree; the receiver merges and trains with probability
  ``min(1, deg_sender / deg_receiver)``, else adopts the received model.
- :class:`SamplingGossipSimulator`, :class:`PartitioningGossipSimulator`
  (Hegedus 2021): a message carries a sample seed or a partition id, and
  the receiver merges only that subset.
- :class:`CacheNeighGossipSimulator` (Giaretta 2019): received models are
  parked, one slot per neighbour; at its timeout a node pops a random
  parked model, merges with it and trains, then gossips.
- :class:`PENSGossipSimulator` (Onoszko 2021): in a first phase received
  models are scored on local data and the best ones merged; the second
  phase gossips only with the neighbours whose models were picked most.

Dense topologies only: the sparse topology is not ported yet.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..core import CreateModelMode, Topology
from ..handlers.base import ModelState, PeerModel, select_rows, select_state
from ..random import FOLD_ACCEPT, FOLD_FALLBACK, K_CACHE_MERGE, \
    K_CACHE_POP, K_PEER
from .engine import EVAL_ROWS, GossipSimulator, SimState
from .report import SimulationReport


def build_neighbor_table(topology: Topology,
                         reject_duplicates: bool = False) -> np.ndarray:
    """The padded out-neighbour table ``[N, max_deg]`` int32 (``-1``:
    unused slot), neighbours in id order: variant state keyed on a peer's
    slot in its receiver's row (the neighbour cache, PENS's counters)
    takes O(N max_deg) instead of ``[N, N]``. A dense adjacency cannot list
    a neighbour twice, so ``reject_duplicates`` (which the JAX package
    needs for its sparse topology) finds nothing to reject here."""
    if not isinstance(topology, Topology):
        raise NotImplementedError(f"{type(topology).__name__} is not ported "
                                  "yet (the dense Topology only)")
    n = topology.num_nodes
    max_deg = max(int(topology.degrees.max()) if n else 0, 1)
    table = np.full((n, max_deg), -1, dtype=np.int32)
    if n:
        i, j = np.nonzero(topology.adjacency)
        pos = np.arange(len(i)) - np.searchsorted(i, i, side="left")
        table[i, pos] = j
    return table


def _slot_of(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The slot of ``ids[i]`` in row ``i`` of a neighbour table, ``-1``
    where it is not there; ``[N]`` int64."""
    match = table == ids.long()[:, None]
    return torch.where(match.any(dim=1), match.to(torch.int8).argmax(dim=1),
                       torch.full_like(ids, -1, dtype=torch.int64))


class PassThroughGossipSimulator(GossipSimulator):
    """Giaretta 2019 pass-through nodes: a message carries the sender's
    degree; the receiver merge-updates with probability ``min(1,
    deg_sender / deg_receiver)`` (a per-row draw from the slot's stream,
    ``fold_in(row key, 911)`` in the JAX package) and otherwise adopts the
    received model as it is, hiding the power-law degree bias."""

    # The decode is the identity and the receive reads the receiver's
    # degree by node id and draws per row: compaction-safe.
    _compact_safe = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._deg = torch.as_tensor(self.topology.degrees,
                                    device=self.device).to(torch.int32)

    def _send_extra(self, state, r, purpose, sub=0):
        return self._deg

    def _reply_extra(self, state, r, purpose):
        return self._deg

    def _decode_extra(self, extra):
        return extra

    def _receive_rows(self, models, peer, data, perms, extra_arg, node_ids,
                      call):
        deg_self = torch.clamp(self._deg[node_ids].to(torch.float32),
                               min=1.0)
        p = torch.clamp(extra_arg.to(torch.float32) / deg_self, max=1.0)
        u = self.draws.row_uniform(call[0], call[1], self.n_nodes,
                                   FOLD_ACCEPT, self.device)[node_ids]
        normal = super()._receive_rows(models, peer, data, perms, None,
                                       node_ids, call)
        passed = ModelState(peer.params, models.opt_state, peer.n_updates)
        return select_state(u < p, normal, passed)


class SamplingGossipSimulator(GossipSimulator):
    """Hegedus 2021 sampled-merge exchange: each message carries a 31-bit
    sample seed; the receiver derives the coordinate mask from it
    (:meth:`DrawProvider.sample_mask`) and merges only those coordinates
    (``SamplingSGDHandler``)."""

    _compact_safe = True   # the mask is a function of each row's payload

    def _send_extra(self, state, r, purpose, sub=0):
        return self.draws.randint(r, purpose, 0, 2 ** 31 - 2, self.n_nodes,
                                  self.device, sub).to(torch.int32)

    def _reply_extra(self, state, r, purpose):
        return self._send_extra(state, r, purpose)

    def _decode_extra(self, extra):
        return self.draws.sample_mask(extra, self.handler.layout,
                                      self.handler.sample_size)


class PartitioningGossipSimulator(GossipSimulator):
    """Hegedus 2021 partitioned exchange: every message (and reply) carries
    a uniformly drawn partition id; the receiver merges only that part
    (``PartitionedSGDHandler``)."""

    _compact_safe = True   # the partition id passes through as it is

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if not hasattr(self.handler, "partition"):
            raise ValueError("PartitioningGossipSimulator requires a "
                             "PartitionedSGDHandler")
        self.n_parts = self.handler.partition.n_parts

    def _send_extra(self, state, r, purpose, sub=0):
        return self.draws.randint(r, purpose, 0, self.n_parts - 1,
                                  self.n_nodes, self.device, sub).to(
                                      torch.int32)

    def _reply_extra(self, state, r, purpose):
        return self._send_extra(state, r, purpose)

    def _decode_extra(self, extra):
        return extra


class CacheNeighGossipSimulator(GossipSimulator):
    """Giaretta 2019 neighbour-cache nodes: one model slot per neighbour.
    A received model is parked in its sender's slot (the latest wins); at
    its timeout a node pops a random occupied slot (``K_CACHE_POP``),
    merge-updates with it (``K_CACHE_MERGE``) and then gossips.

    The parked ``[N, max_deg, stride]`` models are stored in the ring's
    wire format (they are received payloads), with one float32 scale per
    (node, slot, leaf) on an int8 ring.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        table = build_neighbor_table(self.topology, reject_duplicates=True)
        self.max_deg = table.shape[1]
        self.nbr_table = torch.as_tensor(table, device=self.device).long()

    def _init_aux(self, model: ModelState) -> dict:
        n, stride = model.params.shape
        S, dev = self.max_deg, model.params.device
        ages = model.n_updates
        aux = {
            "cache_params": torch.zeros(
                (n, S, stride), dtype=self._HISTORY_DTYPES[self.history_dtype],
                device=dev),
            "cache_age": torch.zeros((n, S) + tuple(ages.shape[1:]),
                                     dtype=ages.dtype, device=dev),
            "cache_valid": torch.zeros((n, S), dtype=torch.bool, device=dev),
        }
        if self.history_dtype == "int8":
            # Scale 1 on the never-read empty slots keeps a decode finite.
            aux["cache_scale"] = torch.ones(
                (n, S, len(self._leaf_spans)), dtype=torch.float32,
                device=dev)
        return aux

    def _send_extra(self, state, r, purpose, sub=0):
        # The receive hook sees the payload, not the mailbox's sender
        # field: the sender id rides in it.
        return torch.arange(self.n_nodes, dtype=torch.int32,
                            device=self.device)

    def _reply_extra(self, state, r, purpose):
        return self._send_extra(state, r, purpose)

    def _apply_receive(self, state, peer, extra, valid, perms, call):
        """Park each live message in its sender's slot of the receiver's
        row, re-encoded into the wire format (lossless: the symmetric int8
        grid maps back to the same scale)."""
        aux = state.aux
        slot = _slot_of(self.nbr_table, extra)
        ok = valid & (slot >= 0)
        idx = torch.arange(self.n_nodes, device=self.device)
        slot_c = slot.clamp(min=0)
        stored, scales = self._encode_history_rows(peer.params)

        def park(name, new):
            cache = aux[name]
            cache[idx, slot_c] = select_rows(ok, new, cache[idx, slot_c])

        park("cache_params", stored)
        if scales is not None:
            park("cache_scale", scales)
        park("cache_age", peer.n_updates)
        park("cache_valid", torch.ones_like(ok))

    def _pre_send(self, state, r):
        """At the timeout, pop a random occupied slot and merge-update with
        it before the snapshot and the sends."""
        aux = state.aux
        fires, _ = self._fire_mask(state, r, 0)
        valid = aux["cache_valid"]
        pick = self.draws.choice(r, K_CACHE_POP, valid)
        do = fires & valid.any(dim=1)
        if not bool(do.any()):
            return
        idx = torch.arange(self.n_nodes, device=self.device)
        pick = pick.clamp(0, self.max_deg - 1)
        scales = (aux["cache_scale"][idx, pick]
                  if self.history_dtype == "int8" else None)
        cached = PeerModel(
            self._decode_history_rows(aux["cache_params"][idx, pick], scales),
            aux["cache_age"][idx, pick])
        split = self.handler.mode == CreateModelMode.UPDATE_MERGE
        perms = self._update_orders(r, [K_CACHE_MERGE],
                                    torch.zeros_like(idx), split)
        merged = self.handler.call(state.model, cached, self._local_data(),
                                   perms)
        state.model = select_state(do, merged, state.model)
        valid[idx, pick] = valid[idx, pick] & ~do


class PENSGossipSimulator(GossipSimulator):
    """Onoszko 2021 PENS peer selection.

    Phase 1 (the first ``step1_rounds`` rounds): each received model is
    scored by its accuracy on the receiver's local training data and
    buffered, one entry per sender (the latest wins); once ``n_sampled``
    are buffered, the ``m_top`` best are averaged with the node's own model
    and trained, and their senders' counters grow. Phase 2: a node gossips
    only with neighbours whose counter beats ``m_top / n_sampled`` of the
    times it picked them. PUSH, MERGE_UPDATE only. :meth:`start` runs the
    two phases as two segments, the second under the draw provider's
    ``derive(2)`` (the JAX base key ``fold_in(key, 2)``).
    """

    def __init__(self, *args, n_sampled: int = 10, m_top: int = 2,
                 step1_rounds: int = 200, **kwargs):
        super().__init__(*args, **kwargs)
        if self.handler.mode != CreateModelMode.MERGE_UPDATE:
            raise ValueError("PENSNode can only be used with MERGE_UPDATE "
                             "mode.")
        max_senders = int(self.topology.degrees.max()) if self.n_nodes else 0
        if n_sampled > max_senders:
            warnings.warn(
                f"PENS n_sampled={n_sampled} exceeds the max in-degree "
                f"({max_senders}): the sender-keyed phase-1 buffer can never "
                "fill, so no node will merge or train in step 1. Consider "
                f"n_sampled <= {max_senders}.")
        self.n_sampled = int(n_sampled)
        self.m_top = int(m_top)
        self.step1_rounds = int(step1_rounds)
        self._step = 1
        table = build_neighbor_table(self.topology, reject_duplicates=True)
        self.max_deg = table.shape[1]
        self.nbr_table = torch.as_tensor(table, device=self.device).long()

    def _init_aux(self, model: ModelState) -> dict:
        n, stride = model.params.shape
        S, Dg, dev = self.n_sampled, self.max_deg, model.params.device
        i32 = dict(dtype=torch.int32, device=dev)
        return {
            "selected": torch.zeros((n, Dg), **i32),
            "neigh_counter": torch.zeros((n, Dg), **i32),
            "cache_params": torch.zeros((n, S, stride), dtype=torch.float32,
                                        device=dev),
            "cache_loss": torch.full((n, S), float("inf"), device=dev),
            "cache_sender": torch.full((n, S), -1, **i32),
            "cache_count": torch.zeros((n,), **i32),
            "best": torch.zeros((n, Dg), dtype=torch.bool, device=dev),
        }

    # -- peer selection -------------------------------------------------

    def _select_peers(self, state, r, f):
        if self._step == 1:
            return self.draws.peers(r, self._adj, sub=f)
        best = state.aux["best"]
        idx = torch.arange(self.n_nodes, device=self.device)
        slot = self.draws.choice(r, K_PEER, best, sub=f).clamp(
            0, self.max_deg - 1)
        fallback = self.draws.peers(r, self._adj, sub=f, fold=FOLD_FALLBACK)
        return torch.where(best.any(dim=1), self.nbr_table[idx, slot],
                           fallback)

    def _send_gate(self, state, active, peers, r, f):
        if self._step == 1:
            # Count each phase-1 pick of a neighbour, by its slot.
            slot = _slot_of(self.nbr_table, peers)
            idx = torch.arange(self.n_nodes, device=self.device)
            state.aux["selected"][idx, slot.clamp(min=0)] += \
                (active & (slot >= 0)).to(torch.int32)
        return active

    # -- receive ----------------------------------------------------------

    @torch.no_grad()
    def _local_accuracy(self, params: torch.Tensor) -> torch.Tensor:
        """Each row's accuracy on its node's local training data, by the
        handler's ``evaluate``, in chunks of at most ``EVAL_ROWS`` node
        samples (a shard longer than that is cut along its samples and
        the correct counts summed)."""
        X, y, m = self._local_data()
        n, s = m.shape
        if n * s <= EVAL_ROWS:
            return self.handler.evaluate(ModelState(params, (), None),
                                         (X, y, m))["accuracy"]
        piece = min(s, EVAL_ROWS)
        rows = max(1, EVAL_ROWS // piece)
        correct = torch.zeros(n, device=params.device)
        for lo in range(0, n, rows):
            p = params[lo:lo + rows]
            for a in range(0, s, piece):
                sl = (slice(lo, lo + rows), slice(a, a + piece))
                acc = self.handler.evaluate(ModelState(p, (), None),
                                            (X[sl], y[sl], m[sl]))["accuracy"]
                correct[lo:lo + rows] += torch.round(acc * m[sl].sum(dim=1))
        count = m.sum(dim=1)
        return torch.where(count > 0, correct / count.clamp(min=1),
                           torch.zeros_like(correct))

    def _apply_receive(self, state, peer, extra, valid, perms, call):
        if self._step == 2:
            return super()._apply_receive(state, peer, extra, valid, perms,
                                          call)
        aux = state.aux
        n, S = self.n_nodes, self.n_sampled
        idx = torch.arange(n, device=self.device)
        loss = -self._local_accuracy(peer.params)
        count = aux["cache_count"]
        sender = extra.to(torch.int32)
        # One buffer entry per sender, the latest model wins.
        match = aux["cache_sender"] == sender[:, None]
        exists = match.any(dim=1)
        pos = torch.where(exists, match.to(torch.int8).argmax(dim=1),
                          count.long().clamp(0, S - 1))
        ok = valid & (exists | (count < S))

        def put(name, new):
            cache = aux[name]
            cache[idx, pos] = select_rows(ok, new, cache[idx, pos])

        put("cache_params", peer.params)
        put("cache_loss", loss)
        put("cache_sender", sender)
        count = count + (ok & ~exists).to(torch.int32)
        # A full buffer flushes: the m_top best merged, then trained.
        flush = count >= S
        if bool(flush.any()):
            top = torch.argsort(aux["cache_loss"], dim=1,
                                stable=True)[:, :self.m_top]
            picked = aux["cache_params"][idx[:, None], top]
            model = state.model
            merged = ModelState((model.params + picked.sum(dim=1))
                                / (self.m_top + 1.0), model.opt_state,
                                model.n_updates)
            trained = self.handler.update(merged, self._local_data(), perms)
            state.model = select_state(flush, trained, model)
            top_senders = torch.gather(aux["cache_sender"], 1, top)
            hit = ((self.nbr_table[:, :, None] == top_senders[:, None, :])
                   & flush[:, None, None]
                   & (top_senders >= 0)[:, None, :])
            aux["neigh_counter"] += hit.sum(dim=-1).to(torch.int32)
            aux["cache_loss"][flush] = float("inf")
            aux["cache_sender"][flush] = -1
        aux["cache_count"] = torch.where(flush, torch.zeros_like(count),
                                         count)

    def _send_extra(self, state, r, purpose, sub=0):
        # The receive hook needs the sender id as a payload field.
        return torch.arange(self.n_nodes, dtype=torch.int32,
                            device=self.device)

    def _decode_extra(self, extra):
        return None if self._step == 2 else extra

    # -- the two phases ---------------------------------------------------

    def _select_neighbors(self, state: SimState) -> None:
        """The phase switch: a neighbour is among the best iff its counter
        beats ``m_top / n_sampled`` of the times it was picked."""
        aux = state.aux
        thresh = self.m_top / self.n_sampled
        best = aux["neigh_counter"].to(torch.float32) > \
            aux["selected"].to(torch.float32) * thresh
        aux["best"] = best & (self.nbr_table >= 0)

    def start(self, state: SimState, n_rounds: int = 100):
        """Run ``n_rounds`` rounds: the phase-1 rounds left before
        ``step1_rounds`` (by the state's round, so a continued run resumes
        in the right phase), then the phase switch and the rest under
        ``draws.derive(2)``. The last round of each segment evaluates."""
        r1 = max(0, min(self.step1_rounds - state.round, n_rounds))
        reports = []
        if r1 > 0:
            self._step = 1
            state, rep = super().start(state, n_rounds=r1)
            reports.append(rep)
        if n_rounds - r1 > 0:
            self._select_neighbors(state)
            self._step = 2
            saved = self.draws
            self.draws = saved.derive(2)
            try:
                state, rep = super().start(state, n_rounds=n_rounds - r1)
            finally:
                self.draws = saved
            reports.append(rep)
        if len(reports) == 1:
            return state, reports[0]
        return state, SimulationReport.concatenate(reports)
