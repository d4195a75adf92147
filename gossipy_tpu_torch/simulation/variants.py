"""Simulator variants: token-account flow control and all-to-all mixing.

Counterpart of ``gossipy_tpu/simulation/variants.py``:

- :class:`TokenizedGossipSimulator`: Danner 2018 token accounts gate the
  sends and trigger reaction sends on receipt;
  :class:`TokenizedPartitioningGossipSimulator` composes it with the
  partitioned exchange (Hegedus 2021).
- :class:`All2AllGossipSimulator`: every node that fires pushes to all its
  peers, and the receivers mix with weights: the whole population's merge
  is one matrix product ``W_eff @ P`` over the flat rows.

The sparse mixing, the mesh and the ring schedule of the all-to-all round
are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core import AntiEntropyProtocol, CreateModelMode, MessageType
from ..flow_control import TokenAccount
from ..handlers.base import ModelState, select_rows, select_state
from ..random import K_A2A_DROP, K_A2A_ONLINE, K_A2A_UPDATE, \
    K_REACT_DELAY, K_REACT_DROP, K_REACT_EXTRA, K_REACT_PEER, \
    K_REACT_SLOT, K_TOKEN_GATE
from ..telemetry import FailureCounts
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
            peers = self.draws.peers(r, self._adj,
                                     purpose=K_REACT_PEER + 10 * j)
            active = (pending > j) & (peers >= 0)
            dropped = self.draws.bernoulli(r, K_REACT_DROP + 10 * j,
                                           self.drop_prob, n, dev)
            delays = self.delay.sample(self.draws, r, K_REACT_DELAY + 10 * j,
                                       n, size, dev)
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


class All2AllGossipSimulator(GossipSimulator):
    """Decentralised SGD with broadcast and weighted mixing (Koloskova et
    al. 2020), on a dense ``[N, N]`` mixing matrix.

    Every node that fires pushes its round-start model to all its peers.
    An edge is live when its sender fired, its message was not dropped
    (one ``[N, N]`` draw) and its receiver is online; the self weight is
    always there. ``W_eff`` is the mixing matrix on the live edges, each
    row renormalised, and the merge of the whole population is ``W_eff @
    P`` (on a bf16 or int8 wire, the exact self term plus the off-diagonal
    product over the wire's round trip of ``P``). A node that received
    anything takes the mixed row and the largest age among its live
    in-edges; every node that fired then trains (UPDATE_MERGE: trains
    first, then mixes). Lost weight is redistributed by the
    renormalisation, and delays collapse to round granularity, as in the
    JAX package.
    """

    def __init__(self, *args, mixing, mesh=None, ring_mix: bool = False,
                 sparse_mix_form: str = "auto", **kwargs):
        if sparse_mix_form not in ("auto", "padded", "segment"):
            raise ValueError(f"unknown sparse_mix_form {sparse_mix_form!r}; "
                             "options: auto, padded, segment")
        if mesh is not None or ring_mix or sparse_mix_form != "auto":
            raise NotImplementedError("mesh=, ring_mix= and the sparse mixing "
                                      "forms are not ported yet")
        if hasattr(mixing, "edge_w"):
            raise NotImplementedError("SparseMixing is not ported yet (a "
                                      "dense [N, N] mixing matrix only)")
        kwargs.setdefault("protocol", AntiEntropyProtocol.PUSH)
        # The round never reads the mailbox: one slot keeps it small.
        kwargs.setdefault("mailbox_slots", 1)
        kwargs.setdefault("fused_merge", False)
        super().__init__(*args, **kwargs)
        if self.protocol != AntiEntropyProtocol.PUSH:
            raise ValueError("All2AllNode only supports PUSH protocol.")
        w = torch.as_tensor(np.asarray(mixing, dtype=np.float32),
                            device=self.device)
        if tuple(w.shape) != (self.n_nodes, self.n_nodes):
            raise ValueError(f"mixing is {tuple(w.shape)}, the topology has "
                             f"{self.n_nodes} nodes")
        self.mixing = w

    def _warn_if_mailbox_undersized(self) -> None:
        """Broadcast mixing loses no message to a full mailbox."""

    def _mix(self, params: torch.Tensor, w_eff: torch.Tensor) -> torch.Tensor:
        if self.history_dtype == "float32":
            return w_eff @ params
        w_diag = torch.diagonal(w_eff)
        w_off = w_eff - torch.diag(w_diag)
        return w_diag[:, None] * params + w_off @ self._wire_roundtrip(params)

    def _train(self, model: ModelState, fires, r: int) -> ModelState:
        perms = self._update_orders(
            r, [K_A2A_UPDATE],
            torch.zeros(self.n_nodes, dtype=torch.int64, device=self.device))
        updated = self.handler.update(model, self._local_data(), perms)
        return select_state(fires, updated, model)

    def _round(self, state: SimState, last_round=None) -> dict:
        r = state.round
        n, dev = self.n_nodes, self.device
        self._snapshot(state, r)
        fires, _ = self._fire_mask(state, r, 0)
        online = self.draws.bernoulli(r, K_A2A_ONLINE, self.online_prob, n,
                                      dev)
        drop = self.draws.bernoulli(r, K_A2A_DROP, self.drop_prob, (n, n),
                                    dev)
        sent_mask = self._adj & fires[None, :]          # [receiver, sender]
        live = sent_mask & ~drop & online[:, None]
        mix = self.mixing
        w = mix * live + torch.diag(torch.diagonal(mix))
        w_eff = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-12)
        n_sent = sent_mask.sum()
        n_drop = (sent_mask & drop).sum()
        n_offline = (sent_mask & ~drop & ~online[:, None]).sum()
        received = (live & (mix > 0)).any(dim=1)

        model = state.model
        if self.handler.mode == CreateModelMode.UPDATE_MERGE:
            model = self._train(model, fires, r)
        ages = model.n_updates
        live_e = live.view((n, n) + (1,) * (ages.dim() - 1))
        in_age = torch.where(live_e, ages[None], torch.zeros_like(
            ages[None])).amax(dim=1)
        mixed = self._mix(model.params, w_eff)
        model = ModelState(select_rows(received, mixed, model.params),
                           model.opt_state,
                           select_rows(received, torch.maximum(ages, in_age),
                                       ages))
        if self.handler.mode != CreateModelMode.UPDATE_MERGE:
            model = self._train(model, fires, r)
        state.model = model
        local, glob = self._maybe_eval(state, r, last_round)
        state.round = r + 1
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return {
            "sent": n_sent,
            "failed": n_drop + n_offline,
            "failed_drop": n_drop,
            "failed_offline": n_offline,
            "failed_overflow": zero,
            # No mailbox and one merge: zero, kept so that the report's
            # columns line up across simulators.
            "mailbox_hwm": zero,
            "compact_slots": zero,
            "wide_slots": zero,
            "size": n_sent * self._model_size(),
            "local": local,
            "global": glob,
        }
