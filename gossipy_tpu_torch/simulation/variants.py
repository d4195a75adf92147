"""Simulator variants: token-account flow control and all-to-all mixing.

Counterpart of ``gossipy_tpu/simulation/variants.py``:

- :class:`TokenizedGossipSimulator`: Danner 2018 token accounts gate the
  sends and trigger reaction sends on receipt;
  :class:`TokenizedPartitioningGossipSimulator` composes it with the
  partitioned exchange (Hegedus 2021).
- :class:`All2AllGossipSimulator`: every node that fires pushes to all its
  peers, and the receivers mix with weights: the whole population's merge
  is one matrix product ``W_eff @ P`` over the flat rows, or over a sparse
  topology a gather and a per-receiver sum over the O(E) edges.

With ``mesh=`` and ``ring_mix=True`` the all-to-all mixing product runs
as a ring over the mesh's node axis
(:func:`~gossipy_tpu_torch.parallel.collectives.ring_mix_pytree`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core import AntiEntropyProtocol, CreateModelMode, MessageType, \
    SparseMixing
from ..flow_control import TokenAccount
from ..handlers.base import ModelState, select_rows, select_state
from ..random import K_A2A_DROP, K_A2A_ONLINE, K_A2A_UPDATE, \
    K_REACT_DELAY, K_REACT_DROP, K_REACT_EXTRA, K_REACT_PEER, \
    K_REACT_SLOT, K_TOKEN_GATE
from ..telemetry import FailureCounts
from ..telemetry import scopes as _scopes
from ..telemetry.probes import consensus_stats, sq_param_distance
from .engine import _PROTO_TO_MSG, GossipSimulator, SimState
from .nodes import PartitioningGossipSimulator


class TokenizedGossipSimulator(GossipSimulator):
    """Gossip with Danner 2018 token-account flow control.

    Per-node int32 balances live in ``state.aux``:

    - at its timeout a node sends with probability
      ``account.proactive(balance)``, else it banks a token;
    - on receiving a message that asks for no reply, the receiver performs
      ``account.reactive(balance, utility)`` reaction sends, capped at
      ``max_reactions`` a round; only the sends performed are debited.
      The reactions go out after the deliver phase, in waves, and arrive
      from the next round on.

    ``utility_fun(receiver_model, sender_snapshot) -> [N]`` gives each
    message's utility (1 by default, as the original experiment). The
    reactions originate from the receiver (the original gossipy's
    reactive loop reuses a stale node variable; the JAX package fixes it).
    """

    def __init__(self, *args, token_account: TokenAccount,
                 utility_fun: Optional[Callable] = None,
                 max_reactions: int = 3, **kwargs):
        super().__init__(*args, **kwargs)
        self.account = token_account
        self.utility_fun = utility_fun or (
            lambda recv_model, sender_snap: torch.ones(
                self.n_nodes, device=self.device))
        self.max_reactions = int(max_reactions)

    def _init_aux(self, model: ModelState) -> dict:
        n, dev = model.params.shape[0], model.params.device
        return {"balance": self.account.init_balance(n, dev),
                "pending_reactions": torch.zeros(n, dtype=torch.int32,
                                                 device=dev)}

    def _send_gate(self, state, active, peers, r, f):
        aux = state.aux
        balance = aux["balance"]
        p = torch.clamp(self.account.proactive(balance), 0.0, 1.0)
        gate = self.draws.uniform(r, K_TOKEN_GATE, self.n_nodes,
                                  self.device, sub=f) < p
        # A node that timed out but was gated banks a token.
        aux["balance"] = balance + (active & ~gate).to(torch.int32)
        return active & gate

    def _post_receive_slot(self, state, valid, ty, sender, send_round, extra,
                           r, k):
        aux = state.aux
        wants_reply = (ty == MessageType.PULL) | (ty == MessageType.PUSH_PULL)
        trigger = valid & ~wants_reply
        # The utility of the snapshot the message carries (its send
        # round's), not this round's.
        peer = self._gather_peer(state, send_round, sender)
        utility = self.utility_fun(state.model, peer)
        balance = aux["balance"]
        u = (self.draws.uniform(r, K_REACT_SLOT + k, self.n_nodes,
                                self.device)
             if self.account.draws_reactive else None)
        reaction = self.account.reactive(
            balance, torch.where(trigger, utility, torch.zeros_like(utility)),
            u)
        reaction = torch.where(trigger, reaction, torch.zeros_like(reaction))
        # Cap at the round's reaction budget; debit only what is sent.
        pending = aux["pending_reactions"]
        performed = torch.minimum(
            reaction, torch.clamp(self.max_reactions - pending, min=0))
        performed = torch.minimum(performed, balance)
        aux["balance"] = balance - performed
        aux["pending_reactions"] = pending + performed

    def _post_deliver(self, state, r):
        """The reaction waves: wave ``j`` sends one message from every node
        with more than ``j`` reactions pending, under the tags ``K_REACT_*
        + 10 j``, to arrive one round later at the earliest (the cell of
        this round is drained already)."""
        n, dev = self.n_nodes, self.device
        size = self._model_size()
        pending = state.aux["pending_reactions"]
        msg_type = int(_PROTO_TO_MSG[self.protocol])
        senders = torch.arange(n, device=dev)
        n_sent, fails, total = 0, FailureCounts(), 0
        waves = min(self.max_reactions, int(pending.max()) if n else 0)
        for j in range(waves):
            fire = pending > j
            if self.chaos is not None:
                # A forced-offline node sends no reaction either; the
                # peer draw runs over the round's alive edges.
                fire = fire & ~self._chaos_forced_offline(r)
            peers = self._chaos_masked_peers(r, purpose=K_REACT_PEER + 10 * j)
            active = fire & (peers >= 0)
            dropped = self.draws.bernoulli(r, K_REACT_DROP + 10 * j,
                                           self._chaos_drop_prob(r), n, dev)
            delays = self._chaos_scale_delays(
                self.delay.sample(self.draws, r, K_REACT_DELAY + 10 * j, n,
                                  size, dev), r)
            dr = torch.clamp(delays // self.delta, min=1)
            sent = active.sum()
            n_sent = n_sent + sent
            total = total + sent * size
            n_overflow = self._scatter_messages(
                state.mailbox, active & ~dropped, dr, peers, senders, r,
                msg_type, self._send_extra(state, r, K_REACT_EXTRA + 10 * j),
                r, self.K)
            fails = fails + FailureCounts(drop=(active & dropped).sum(),
                                          overflow=n_overflow)
        state.aux["pending_reactions"] = torch.zeros_like(pending)
        return n_sent, fails, total


class TokenizedPartitioningGossipSimulator(TokenizedGossipSimulator,
                                           PartitioningGossipSimulator):
    """Token-account flow control over the partitioned exchange
    (Hegedus 2021): the token gate and reactions of the first base, the
    partition-id payloads of the second."""


class _Edges(NamedTuple):
    """One all-to-all round's live edges, whatever the mixing's form:
    the accounting, each receiver's accepted count, and the merge."""

    sent: torch.Tensor
    drop: torch.Tensor
    offline: torch.Tensor
    chaos: Optional[torch.Tensor]
    accepted: torch.Tensor          # [N] int32: live in-edges, weight > 0
    mix: Callable                   # params [N, stride] -> mixed rows
    in_age: Callable                # ages -> the largest live in-edge age
    nonfinite: torch.Tensor         # non-finite effective weights


class All2AllGossipSimulator(GossipSimulator):
    """Decentralised SGD with broadcast and weighted mixing (Koloskova et
    al. 2020).

    Every node that fires pushes its round-start model to all its peers.
    An edge is live when its sender fired, its message was not dropped
    and its receiver is online; the self weight is always there. ``W_eff``
    is the mixing matrix on the live edges, each row renormalised. A node
    that received anything takes the mixed row and the largest age among
    its live in-edges; every node that fired then trains (UPDATE_MERGE:
    trains first, then mixes). Lost weight is redistributed by the
    renormalisation, and delays collapse to round granularity, as in the
    JAX package.

    The mixing is a dense ``[N, N]`` matrix or, over a
    :class:`~gossipy_tpu_torch.core.SparseTopology`, the O(E) edge weights
    of a :class:`~gossipy_tpu_torch.core.SparseMixing`:

    - dense: one ``[N, N]`` drop draw, and the merge of the whole
      population is ``W_eff @ P`` (on a bf16 or int8 wire, the exact self
      term plus the off-diagonal product over the wire's round trip);
    - ``sparse_mix_form="padded"``: the weights padded into ``[N,
      max_deg]`` tables, the drop drawn over that shape, the merge a
      gather of the senders' rows and an ``einsum``; refused on a
      heavy-tailed degree distribution, where padding to the hub's degree
      would cost O(N max_deg);
    - ``"segment"``: the drop drawn over the ``[2E]`` edges, the merge a
      gather of the senders' rows and an ``index_add_`` into the
      receivers (the JAX package's ``segment_sum``).

    ``"auto"`` takes ``"segment"``: the JAX package's rule off the TPU, so
    a run on the card and one on the CPU make the same draws.

    With ``ring_mix=True`` (requires ``mesh``) the dense mixing product
    runs as a ring matmul over the mesh's node axis
    (:func:`~gossipy_tpu_torch.parallel.collectives.ring_mix_pytree`): on
    an fp32 wire the single product, on a bf16 or int8 wire the exact
    diagonal plus the off-diagonal product over the wire's round trip.
    Sparse mixing refuses it.
    """

    def __init__(self, *args, mixing, mesh=None, ring_mix: bool = False,
                 sparse_mix_form: str = "auto", **kwargs):
        if sparse_mix_form not in ("auto", "padded", "segment"):
            raise ValueError(f"unknown sparse_mix_form {sparse_mix_form!r}; "
                             "options: auto, padded, segment")
        kwargs.setdefault("protocol", AntiEntropyProtocol.PUSH)
        # The round never reads the mailbox: one slot keeps it small.
        kwargs.setdefault("mailbox_slots", 1)
        kwargs.setdefault("fused_merge", False)
        super().__init__(*args, **kwargs)
        if self.protocol != AntiEntropyProtocol.PUSH:
            raise ValueError("All2AllNode only supports PUSH protocol.")
        self.sparse_mix = isinstance(mixing, SparseMixing)
        self._sparse_padded = False
        self._init_ring_mix(mesh, ring_mix)
        if self.sparse_mix:
            self._init_sparse_mixing(mixing, sparse_mix_form)
            return
        if self._sparse:
            raise ValueError("a SparseTopology requires SparseMixing (pass "
                             "uniform_mixing(sparse_topology)); dense "
                             "mixing arrays need a dense Topology")
        w = torch.as_tensor(np.asarray(mixing, dtype=np.float32),
                            device=self.device)
        if tuple(w.shape) != (self.n_nodes, self.n_nodes):
            raise ValueError(f"mixing is {tuple(w.shape)}, the topology has "
                             f"{self.n_nodes} nodes")
        self.mixing = w

    def _init_ring_mix(self, mesh, ring_mix: bool) -> None:
        """The ring schedule of the mixing product (JAX variants.py:
        295-307): over the same axes the node dimension is placed on, the
        node count dividing the ring."""
        self.mesh = mesh
        self.ring_mix = bool(ring_mix)
        if mesh is not None:
            from ..parallel import _ACROSS_CARDS, canonical_device
            if not mesh.is_virtual() or mesh.device() != canonical_device(
                    self.device):
                raise NotImplementedError(_ACROSS_CARDS)
        if not self.ring_mix:
            return
        if mesh is None:
            raise ValueError("ring_mix=True requires a mesh")
        if self.sparse_mix:
            raise ValueError("ring_mix schedules the dense mixing matmul; "
                             "use the segment-sum sparse path without a "
                             "ring")
        from ..parallel import _node_axis_entry
        from ..parallel.collectives import _axis_size
        self._ring_axis = _node_axis_entry(mesh, None)
        if self.n_nodes % _axis_size(mesh, self._ring_axis):
            raise ValueError("node count must divide the mesh's node axes "
                             "for ring_mix")

    def _init_sparse_mixing(self, mixing: SparseMixing, form: str) -> None:
        """Check the edge weights, move them to the device and, for the
        padded form, lay them out in ``[N, max_deg]`` tables."""
        if mixing.num_nodes != self.n_nodes:
            raise ValueError("mixing/topology node-count mismatch: "
                             f"{mixing.num_nodes} vs {self.n_nodes}")
        rows = np.asarray(mixing.rows)
        if rows.size and not (np.diff(rows) >= 0).all():
            raise ValueError("SparseMixing.rows must be non-decreasing "
                             "(CSR row order)")
        degrees = np.bincount(rows, minlength=self.n_nodes)
        max_deg = int(degrees.max()) if rows.size else 0
        mean_deg = float(degrees.mean()) if rows.size else 0.0
        near_regular = max_deg > 0 and max_deg <= max(4.0 * mean_deg, 8.0)
        if form == "padded" and not near_regular:
            raise ValueError(
                "sparse_mix_form='padded' on a heavy-tailed degree "
                f"distribution (max {max_deg} vs mean {mean_deg:.1f}) would "
                "pad O(N * max_deg); use 'segment'")
        self._sparse_padded = form == "padded"
        dev = self.device
        self.mixing = SparseMixing(
            torch.as_tensor(np.asarray(mixing.edge_w, np.float32), device=dev),
            torch.as_tensor(np.asarray(mixing.self_w, np.float32), device=dev),
            torch.as_tensor(rows, device=dev).long(),
            torch.as_tensor(np.asarray(mixing.senders), device=dev).long(),
            self.n_nodes)
        if self._sparse_padded:
            senders = np.asarray(mixing.senders)
            pos = np.arange(len(rows)) - np.searchsorted(rows, rows)
            nbr = np.zeros((self.n_nodes, max_deg), np.int64)
            wt = np.zeros((self.n_nodes, max_deg), np.float32)
            valid = np.zeros((self.n_nodes, max_deg), bool)
            nbr[rows, pos] = senders
            wt[rows, pos] = np.asarray(mixing.edge_w)
            valid[rows, pos] = True
            self._nbr_tab = torch.as_tensor(nbr, device=dev)
            self._w_tab = torch.as_tensor(wt, device=dev)
            self._slot_valid = torch.as_tensor(valid, device=dev)
            # CSR edge -> padded slot: where the chaos per-edge alive mask
            # lands in the slot layout (one table per schedule mask).
            self._pad_at = (torch.as_tensor(rows, device=dev).long(),
                            torch.as_tensor(pos, device=dev).long())
            self._pad_alive: dict = {}

    def _warn_if_mailbox_undersized(self) -> None:
        """Broadcast mixing loses no message to a full mailbox."""

    def _mix(self, params: torch.Tensor, w_eff: torch.Tensor) -> torch.Tensor:
        if self.ring_mix:
            from ..parallel.collectives import ring_mix_pytree

            def mm(w, x):
                return ring_mix_pytree(w, x, self.mesh, self._ring_axis)
        else:
            def mm(w, x):
                return w @ x
        if self.history_dtype == "float32":
            return mm(w_eff, params)
        w_diag = torch.diagonal(w_eff)
        w_off = w_eff - torch.diag(w_diag)
        return w_diag[:, None] * params + mm(w_off,
                                             self._wire_roundtrip(params))

    def _wire(self, params: torch.Tensor) -> torch.Tensor:
        """What the peers receive of ``params``: the rows themselves on an
        fp32 wire, else their round trip through the wire format."""
        if self.history_dtype == "float32":
            return params
        return self._wire_roundtrip(params)

    def _train(self, model: ModelState, fires, r: int) -> ModelState:
        perms = self._update_orders(
            r, [K_A2A_UPDATE],
            torch.zeros(self.n_nodes, dtype=torch.int64, device=self.device))
        with _scopes.phase_scope(_scopes.PHASE_TRAIN):
            updated = self.handler.update(model, self._local_data(), perms)
        return select_state(fires, updated, model)

    def _chaos_mask_idx(self, r: int) -> Optional[int]:
        """The round's edge-alive mask index under partitions or churn,
        else None."""
        if not self._chaos_edges:
            return None
        return int(self.chaos_schedule.mask_idx[self._chaos_t(r)])

    def _dense_edges(self, r, fires, online, forced) -> _Edges:
        n, dev = self.n_nodes, self.device
        drop = self.draws.bernoulli(r, K_A2A_DROP, self._chaos_drop_prob(r),
                                    (n, n), dev)
        sent = self._round_adjacency(r) & fires[None, :]  # [recv, sender]
        live = sent & ~drop & online[:, None]
        mix = self.mixing
        w = mix * live + torch.diag(torch.diagonal(mix))
        w_eff = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-12)

        def in_age(ages):
            live_e = live.view((n, n) + (1,) * (ages.dim() - 1))
            return torch.where(live_e, ages[None],
                               torch.zeros_like(ages[None])).amax(dim=1)

        accepted = (live & (mix > 0)).sum(dim=1, dtype=torch.int32)
        return self._edges_out(
            sent, drop, ~online[:, None],
            None if forced is None else forced[:, None], accepted,
            lambda p: self._mix(p, w_eff), in_age,
            (~torch.isfinite(w_eff)).sum(dtype=torch.int32))

    def _padded_edges(self, r, fires, online, forced) -> _Edges:
        mix = self.mixing
        nbr, wt, slot = self._nbr_tab, self._w_tab, self._slot_valid
        m = self._chaos_mask_idx(r)
        if m is not None:
            alive = self._pad_alive.get(m)
            if alive is None:
                alive = torch.zeros_like(slot)
                alive[self._pad_at] = torch.as_tensor(
                    self.chaos_schedule.csr_masks[m], device=self.device)
                alive = self._pad_alive[m] = slot & alive
            slot = alive
        drop = self.draws.bernoulli(r, K_A2A_DROP, self._chaos_drop_prob(r),
                                    tuple(wt.shape), self.device)
        sent = fires[nbr] & slot
        live = sent & ~drop & online[:, None]
        w = wt * live
        inv = 1.0 / torch.clamp(mix.self_w + w.sum(dim=1), min=1e-12)
        w_eff = w * inv[:, None]
        self_eff = mix.self_w * inv

        def merge(params):
            return (self_eff[:, None] * params
                    + torch.einsum("ns,nsd->nd", w_eff,
                                   self._wire(params)[nbr]))

        def in_age(ages):
            live_e = live.view(live.shape + (1,) * (ages.dim() - 1))
            return torch.where(live_e, ages[nbr],
                               torch.zeros_like(ages[nbr])).amax(dim=1)

        accepted = (live & (wt > 0)).sum(dim=1, dtype=torch.int32)
        return self._edges_out(
            sent, drop, ~online[:, None],
            None if forced is None else forced[:, None], accepted, merge,
            in_age, (~torch.isfinite(w_eff)).sum(dtype=torch.int32)
            + (~torch.isfinite(self_eff)).sum(dtype=torch.int32))

    def _segment_edges(self, r, fires, online, forced) -> _Edges:
        n, dev = self.n_nodes, self.device
        mix = self.mixing
        rows, senders = mix.rows, mix.senders
        drop = self.draws.bernoulli(r, K_A2A_DROP, self._chaos_drop_prob(r),
                                    (rows.shape[0],), dev)
        sent = fires[senders]
        m = self._chaos_mask_idx(r)
        if m is not None:
            sent = sent & torch.as_tensor(self.chaos_schedule.csr_masks[m],
                                          device=dev)
        live = sent & ~drop & online[rows]
        w = mix.edge_w * live
        row_sum = mix.self_w + torch.zeros(n, device=dev).index_add_(
            0, rows, w)
        inv = 1.0 / torch.clamp(row_sum, min=1e-12)
        w_eff = w * inv[rows]
        self_eff = mix.self_w * inv
        accepted = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
            0, rows, (live & (mix.edge_w > 0)).to(torch.int32))

        def merge(params):
            contrib = w_eff[:, None] * self._wire(params)[senders]
            return (self_eff[:, None] * params
                    + torch.zeros_like(params).index_add_(0, rows, contrib))

        def in_age(ages):
            tail = (1,) * (ages.dim() - 1)
            vals = torch.where(live.view((-1,) + tail), ages[senders],
                               torch.zeros_like(ages[senders]))
            idx = rows.view((-1,) + tail).expand_as(vals)
            return torch.zeros_like(ages).scatter_reduce_(
                0, idx, vals, "amax")

        return self._edges_out(
            sent, drop, ~online[rows],
            None if forced is None else forced[rows], accepted, merge, in_age,
            (~torch.isfinite(w_eff)).sum(dtype=torch.int32)
            + (~torch.isfinite(self_eff)).sum(dtype=torch.int32))

    @staticmethod
    def _edges_out(sent, drop, recv_offline, recv_forced, accepted, merge,
                   in_age, nonfinite) -> _Edges:
        """The accounting of the sent edges: a dropped message never
        reaches its receiver, so drop is charged first and offline only
        on surviving edges, forced-offline receivers under ``chaos``."""
        n_offline = (sent & ~drop & recv_offline).sum()
        n_chaos = None
        if recv_forced is not None:
            n_chaos = (sent & ~drop & recv_forced).sum()
            n_offline = n_offline - n_chaos
        return _Edges(sent.sum(), (sent & drop).sum(), n_offline, n_chaos,
                      accepted, merge, in_age, nonfinite)

    def _round(self, state: SimState, last_round=None) -> dict:
        r = state.round
        n, dev = self.n_nodes, self.device
        # The phase ranges (telemetry.scopes), as in the JAX variant: the
        # snapshot and the edge draws are the send, the mix the
        # receive_merge, the local update (_train) the train.
        with _scopes.phase_scope(_scopes.PHASE_SEND):
            self._snapshot(state, r)
            fires, _ = self._fire_mask(state, r, 0)
            online = self.draws.bernoulli(r, K_A2A_ONLINE, self.online_prob,
                                          n, dev)
            forced = None
            if self.chaos is not None:
                # A scheduled outage silences a node on both sides of the
                # broadcast; partitions and churn mask the mixed edges.
                forced = self._chaos_forced_offline(r)
                fires = fires & ~forced
                online = online & ~forced
            if not self.sparse_mix:
                edges = self._dense_edges(r, fires, online, forced)
            elif self._sparse_padded:
                edges = self._padded_edges(r, fires, online, forced)
            else:
                edges = self._segment_edges(r, fires, online, forced)
        received = edges.accepted > 0

        # The probes' merge and train deltas: the mix and the local update
        # are separate phases here, so the split is exact.
        deltas = self.probes is not None and self.probes.mixing
        zero_f = torch.zeros((), dtype=torch.float32, device=dev)
        merge_sq = train_sq = zero_f
        spans = self._leaf_spans
        model = state.model
        if self.handler.mode == CreateModelMode.UPDATE_MERGE:
            pre_train = model.params
            model = self._train(model, fires, r)
            if deltas:
                train_sq = sq_param_distance(model.params, pre_train, spans)
        with _scopes.phase_scope(_scopes.PHASE_RECEIVE_MERGE):
            ages = model.n_updates
            mixed = select_rows(received, edges.mix(model.params),
                                model.params)
            if deltas:
                merge_sq = sq_param_distance(mixed, model.params, spans)
            model = ModelState(mixed, model.opt_state,
                               select_rows(received,
                                           torch.maximum(ages,
                                                         edges.in_age(ages)),
                                           ages))
        if self.handler.mode != CreateModelMode.UPDATE_MERGE:
            pre_train = model.params
            model = self._train(model, fires, r)
            if deltas:
                train_sq = sq_param_distance(model.params, pre_train, spans)
        state.model = model
        with _scopes.phase_scope(_scopes.PHASE_EVAL):
            local, glob = self._maybe_eval(state, r, last_round)
        state.round = r + 1
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        stats = {
            "sent": edges.sent,
            "failed": FailureCounts(edges.drop, edges.offline, zero,
                                    edges.chaos).total(),
            "failed_drop": edges.drop,
            "failed_offline": edges.offline,
            "failed_overflow": zero,
            # No mailbox and one merge: zero, kept so that the report's
            # columns line up across simulators.
            "mailbox_hwm": zero,
            "compact_slots": zero,
            "wide_slots": zero,
            "size": edges.sent * self._model_size(),
            "local": local,
            "global": glob,
        }
        if self.chaos is not None:
            stats["failed_chaos"] = edges.chaos
            if self._chaos_probes_on():
                stats.update(self._chaos_stats(state, r))
        if self.probes is not None:
            stats.update(self._a2a_probe_stats(state, edges.accepted,
                                               merge_sq, train_sq))
        if self._health_slots_on():
            # The mixing weights are the one quantity this round owns that
            # the engine's vitals cannot see: a non-finite weight poisons
            # every row it touches before any param goes bad.
            stats["health_mix_nonfinite"] = edges.nonfinite
        return stats

    def _a2a_probe_stats(self, state: SimState, acc, merge_sq,
                         train_sq) -> dict:
        """The round's ``probe_*`` entries. Every mixed contribution is a
        round-start snapshot: staleness is 0, the whole histogram sits in
        bucket 0, and the accepted merges ``acc`` are each node's live
        in-edges with a positive weight."""
        cfg = self.probes
        dev = self.device
        out: dict = {}
        if cfg.consensus:
            cm, cx, cl = consensus_stats(state.model.params, self._leaf_spans)
            out["probe_consensus_mean"] = cm
            out["probe_consensus_max"] = cx
            out["probe_consensus_per_layer"] = cl
        if cfg.staleness:
            hist = torch.zeros(cfg.staleness_buckets, dtype=torch.int32,
                               device=dev)
            hist[0] = acc.sum(dtype=torch.int32)
            out["probe_stale_mean"] = torch.zeros((), dtype=torch.float32,
                                                  device=dev)
            out["probe_stale_max"] = torch.zeros((), dtype=torch.int32,
                                                 device=dev)
            out["probe_stale_hist"] = hist
        if cfg.mixing:
            out["probe_accepted_per_node"] = acc
            out["probe_merge_delta"] = torch.sqrt(merge_sq)
            out["probe_train_delta"] = torch.sqrt(train_sq)
        return out

    def _probe_expected_fanin(self) -> np.ndarray:
        """Broadcast mixing: every in-neighbour's send reaches a node each
        round, thinned by the per-edge drop draw and the receiver's online
        draw."""
        if self.sparse_mix:
            rows = self.mixing.rows.cpu().numpy()
            w = self.mixing.edge_w.cpu().numpy()
            indeg = np.bincount(rows[w > 0], minlength=self.n_nodes
                                ).astype(np.float64)
        else:
            mix = self.mixing.cpu().numpy()
            adj = np.asarray(self.topology.adjacency).astype(bool)
            indeg = (adj & (mix > 0)).sum(axis=1).astype(np.float64)
        return indeg * (1.0 - self.drop_prob) * self.online_prob
