"""The sequential high-fidelity engine, for small-N verification studies.

Counterpart of ``gossipy_tpu/simulation/sequential.py``. The bulk engine
(:mod:`.engine`) trades three fidelity corners of the reference loop for
whole-population rounds: per-round observer events in place of
per-message ones, token reactions delivered next round in place of the
same tick, and round-start snapshots in place of in-round sequential
state. :class:`SequentialGossipSimulator` closes all three for
populations small enough that a Python event loop is affordable
(hundreds of nodes, tens of rounds): the tick loop schedules on the host,
and every event is one node's ``handler.call`` on the run's device. It is
a verification instrument, not the performance path: audit the bulk
engine's divergences on a configuration with it, then run the study on
the bulk engine.

Event-order contract (the reference tick loop, as the JAX engine keeps
it): per tick ``t`` — (a) the send sweep over a per-round shuffled node
order, each sender sending its CURRENT model (merges earlier in the same
tick included); (b) the arrival drain for ``t`` (online check per
receiver, ``handler.call``, replies and token reactions scheduled at ``t
+ delay``: a zero delay lands back in the queue being drained and
cascades); (c) the reply drain; (d) at round boundaries, evaluation and
the per-round events. Receivers also get a live
``update_single_message(failed, record)`` per message.

Two deliberate divergences from the reference loop, both reference bugs
the JAX engine also fixes: an isolated sender skips its send instead of
aborting the sweep, and a token reaction originates at the receiver.

The population is one stacked :class:`~..handlers.base.ModelState` on
the device (``[N, stride]`` params, the optimizer state, the ages), where
the JAX engine keeps a list of per-node states: an event is a one-row
``handler.call`` on ``[i:i+1]``, written back in place, and evaluation,
probes and sentinels read the stacked tensor as it is. A message's
payload is a copy of the sender's row taken at send time, so a sender
that merges before the delivery does not change what it sent.

Scheduling state stays on the host (numpy): the queues, the phases, the
token balances and every decision. Random draws come from the
simulation's :class:`~gossipy_tpu_torch.random.DrawProvider` by event:
two host generators seeded at the start of a run, and one event counter
that every handler call, delay sample and token reaction advances, in
the JAX engine's order. The per-round device values (metrics, probe
deltas, consensus, vitals) are read once, when the run ends: the tick
loop never waits on the card unless a ``utility_fun`` reads it.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core import AntiEntropyProtocol, ConstantDelay, CreateModelMode, \
    Delay, MessageType
from ..data import to_device
from ..flow_control import TokenAccount
from ..handlers.base import ModelState, PeerModel
from ..random import DrawProvider, TorchDraws
from ..telemetry.health import HealthCarry, SentinelConfig, \
    health_round_stats
from ..telemetry.probes import ProbeConfig, consensus_stats, \
    param_layer_names, sq_param_distance
from .engine import _PROTO_TO_MSG, metric_names, population_metrics
from .events import SimulationEventSender
from .faults import ChaosConfig, build_fault_schedule, chaos_round_stats
from .nodes import build_neighbor_table
from .report import SimulationReport

# Node-behaviour variants the sequential engine replicates for parity
# studies against the bulk engine's subclasses (simulation.nodes).
SEQ_VARIANTS = ("passthrough", "cache_neigh")


@dataclass
class MessageRecord:
    """Per-message observer payload (the reference's ``Message`` view:
    timestamp, type, sender, receiver, size)."""

    t: int
    round: int
    sender: int
    receiver: int
    msg_type: MessageType
    size: int


@dataclass
class SeqState:
    """Sequential simulation state: the stacked population on the run's
    device, the host scheduling state and the rounds run so far."""

    model: ModelState                  # [N, stride] params, opt, [N] ages
    phase: np.ndarray                  # [N] sync offset or async period
    balance: Optional[np.ndarray]      # [N] token balances (tokenized only)
    round: int = 0


@dataclass
class _Pending:
    """A scheduled delivery: the payload is the sender's row at send
    time, a copy (None for a PULL request)."""

    rec: MessageRecord
    payload: Optional[PeerModel]
    is_reply: bool = False


class _EventDelayDraws:
    """What :meth:`Delay.sample` draws for one event: its ``randint`` is
    the event's."""

    def __init__(self, draws: DrawProvider, e: int):
        self.draws, self.e = draws, e

    def randint(self, r, purpose, lo, hi, n, device, sub=0):
        return torch.tensor([self.draws.event_randint(self.e, lo, hi)])


class SequentialGossipSimulator(SimulationEventSender):
    """Reference-faithful sequential gossip for small N (module doc).

    Parameters follow ``gossipy_tpu.simulation.SequentialGossipSimulator``:

    token_account, utility_fun
        Danner 2018 flow control with same-tick reactions;
        ``utility_fun(receiver, payload) -> float`` gets the receiver's
        one-row :class:`ModelState` and the message's :class:`PeerModel`
        (constant 1 by default).
    variant : None | "passthrough" | "cache_neigh"
        Replicates a node-behaviour subclass: Giaretta 2019's
        degree-biased accept-or-adopt, or one parked model per neighbour,
        popped and merged at send time. Its draws come from a host
        generator of their own, so pass-through with accept probability 1
        reproduces the vanilla run bit for bit. Excludes
        ``token_account``.
    probes, sentinels, chaos
        As in :class:`~.engine.GossipSimulator`: the same quantities,
        accumulated per message and per round.
    draws : DrawProvider | None
        Source of every random draw (default ``TorchDraws(42)``).
    device : str | torch.device | None
        ``cuda`` unless ``"cpu"`` is passed; raises without a card.
    """

    def __init__(self,
                 handler,
                 topology,
                 data: dict,
                 delta: int = 100,
                 protocol: AntiEntropyProtocol = AntiEntropyProtocol.PUSH,
                 drop_prob: float = 0.0,
                 online_prob: float = 1.0,
                 delay: Delay = ConstantDelay(0),
                 sampling_eval: float = 0.0,
                 sync: bool = True,
                 token_account: Optional[TokenAccount] = None,
                 utility_fun: Optional[Callable] = None,
                 probes=None,
                 sentinels=None,
                 variant: Optional[str] = None,
                 chaos=None,
                 draws: Optional[DrawProvider] = None,
                 device=None):
        if not (0 <= drop_prob < 1 and 0 < online_prob <= 1):
            raise ValueError("need 0 <= drop_prob < 1 and 0 < online_prob <= 1")
        if variant is not None and variant not in SEQ_VARIANTS:
            raise ValueError(f"unknown sequential variant {variant!r}; "
                             f"options: {SEQ_VARIANTS}")
        if variant is not None and token_account is not None:
            raise ValueError("variant= and token_account= are mutually "
                             "exclusive (the bulk engines compose them by "
                             "subclassing; the sequential modes do not)")
        self.variant = variant
        self.handler = handler
        self.topology = topology
        self.n_nodes = topology.num_nodes
        if self.n_nodes > 512:
            warnings.warn(
                "SequentialGossipSimulator is a verification mode; "
                f"{self.n_nodes} nodes will be slow — use GossipSimulator "
                "for studies at this scale.")
        self.device = resolve_device(device)
        self.delta = int(delta)
        self.protocol = AntiEntropyProtocol(protocol)
        self.drop_prob = float(drop_prob)
        self.online_prob = float(online_prob)
        self.delay = delay
        self.sampling_eval = float(sampling_eval)
        self.sync = bool(sync)
        self.account = token_account
        self.utility_fun = utility_fun or (lambda recv, snap: 1.0)
        self.draws = draws if draws is not None else TorchDraws(42)
        self.data = to_device(data, self.device)
        self.has_local_test = "xte" in self.data
        self.has_global_eval = "x_eval" in self.data
        # Each node's training shard, one-row views, sliced once.
        xtr, ytr, mtr = (self.data[k] for k in ("xtr", "ytr", "mtr"))
        self._node_data = [(xtr[i:i + 1], ytr[i:i + 1], mtr[i:i + 1])
                           for i in range(self.n_nodes)]
        # Out-neighbour lists on the host (peer sampling is scheduling). A
        # duplicate edge of a multigraph row raises that peer's weight, as
        # in the reference.
        self._nbrs = [row[row >= 0] for row in build_neighbor_table(topology)]
        self._size = int(handler.get_size())
        layout = handler.layout
        self._spans = [(layout.offsets[name], math.prod(shape))
                       for name, shape in layout.leaves]
        self._layer_names = param_layer_names(layout)
        self._metric_names: Optional[list] = None
        self.probes: Optional[ProbeConfig] = ProbeConfig.coerce(probes)
        self._probe_delta_ok = (
            self.probes is not None and self.probes.mixing
            and handler.mode == CreateModelMode.MERGE_UPDATE
            and variant is None)
        self.sentinels: Optional[SentinelConfig] = \
            SentinelConfig.coerce(sentinels)
        # The sentinels' cross-run state: persists across start() calls,
        # reset with the population.
        self._health_carry: Optional[HealthCarry] = None
        self.chaos: Optional[ChaosConfig] = ChaosConfig.coerce(chaos)
        self._chaos_sched = None
        self._chaos_nbr_cache: dict = {}
        if self.chaos is not None:
            self._chaos_sched = build_fault_schedule(self.chaos, topology,
                                                     self.drop_prob)
            self._chaos_ncomp = self.chaos.max_components()
            self._chaos_comp = torch.as_tensor(
                self._chaos_sched.component_id, device=self.device)
            if self.chaos.has_edge_faults() and isinstance(
                    self._chaos_sched.slot_masks, np.ndarray):
                self._chaos_nbr_table = build_neighbor_table(topology)
        self._cn_cache: list = [dict() for _ in range(self.n_nodes)]

    # -- set-up --------------------------------------------------------------

    def init_nodes(self, generator: Optional[torch.Generator] = None,
                   local_train: bool = True,
                   common_init: bool = False) -> SeqState:
        """Every node's model from the handler's ``init`` under
        ``generator`` (default seeded with 0; ``common_init``: one init
        for all), then one local pre-training pass, node ``i`` on the
        draw provider's ``seq_init_permutations`` row; send offsets (or
        async periods) from one host generator seeded by
        ``seq_init_seed``; token balances from the account."""
        n = self.n_nodes
        g = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        if common_init:
            one = self.handler.init(g, "cpu")
            params = one.params.unsqueeze(0).repeat(n, 1)
            n_updates = one.n_updates.unsqueeze(0).repeat(
                n, *[1] * one.n_updates.dim())
        else:
            inits = [self.handler.init(g, "cpu") for _ in range(n)]
            params = torch.stack([m.params for m in inits])
            n_updates = torch.stack([m.n_updates for m in inits])
        params = params.to(self.device)
        model = ModelState(params, self.handler.init_opt_state(params),
                           n_updates.to(self.device, torch.int32))
        if local_train:
            epochs = self.handler.orders_per_update()
            perms = None if epochs is None else \
                self.draws.seq_init_permutations(
                    n, epochs, self.data["mtr"].shape[1], self.device)
            model = self.handler.update(
                model, tuple(self.data[k] for k in ("xtr", "ytr", "mtr")),
                perms)
        rng = np.random.default_rng(self.draws.seq_init_seed())
        if self.sync:
            phase = rng.integers(0, self.delta, size=n)
        else:
            phase = np.maximum(
                (self.delta + (self.delta / 10.0)
                 * rng.standard_normal(n)).astype(np.int64), 1)
        return self.init_state(model, phase)

    def init_state(self, model: ModelState, phase,
                   balance: Optional[np.ndarray] = None) -> SeqState:
        """A round-0 state around given node models (stacked, their
        optimizer state included) and send offsets or periods; the token
        balances are the account's initial ones unless given. Resets the
        neighbour caches and the sentinels' carry."""
        self._health_carry = None
        self._cn_cache = [dict() for _ in range(self.n_nodes)]
        model = ModelState(
            model.params.to(self.device, torch.float32).contiguous(),
            tuple(t.to(self.device).contiguous() for t in model.opt_state),
            model.n_updates.to(self.device, torch.int32).contiguous())
        if balance is None and self.account is not None:
            balance = self.account.init_balance(self.n_nodes).numpy()
        return SeqState(model=model,
                        # The phases are host values.
                        phase=np.asarray(  # tracelint: disable=np-in-round
                            phase, dtype=np.int64).copy(),
                        balance=None if balance is None
                        else np.asarray(balance, dtype=np.int32).copy())

    # -- rows of the stacked population --------------------------------------

    @staticmethod
    def _row(model: ModelState, i: int) -> ModelState:
        return ModelState(model.params[i:i + 1],
                          tuple(t[i:i + 1] for t in model.opt_state),
                          model.n_updates[i:i + 1])

    @staticmethod
    def _put(model: ModelState, i: int, row: ModelState) -> None:
        model.params[i:i + 1].copy_(row.params)
        for t, v in zip(model.opt_state, row.opt_state):
            t[i:i + 1].copy_(v)
        model.n_updates[i:i + 1].copy_(row.n_updates)

    @staticmethod
    def _peer_view(model: ModelState, i: int) -> PeerModel:
        """Node ``i``'s message payload: a copy of its row and age, so a
        later write to the row leaves the message as it was sent."""
        return PeerModel(model.params[i:i + 1].clone(),
                         model.n_updates[i:i + 1].clone())

    # -- chaos schedule reads (rounds clamp to the trailing baseline row) ----

    def _chaos_row(self, r: int) -> int:
        return min(int(r), self._chaos_sched.rows - 1)

    def _forced_at(self, r: int):
        return self._chaos_sched.forced_offline[self._chaos_row(r)]

    def _drop_prob_at(self, r: int) -> float:
        if self.chaos is None:
            return self.drop_prob
        return float(self._chaos_sched.drop_prob[self._chaos_row(r)])

    def _delay_scale_at(self, r: int) -> float:
        if self.chaos is None:
            return 1.0
        return float(self._chaos_sched.delay_scale[self._chaos_row(r)])

    def _alive_nbrs(self, i: int, r: int):
        """Node ``i``'s out-neighbours alive at round ``r`` (partition and
        churn masks applied; the static list without edge faults). Cached
        per (mask, node)."""
        if self.chaos is None or not self.chaos.has_edge_faults():
            return self._nbrs[i]
        m = int(self._chaos_sched.mask_idx[self._chaos_row(r)])
        if m == 0:
            return self._nbrs[i]
        key = (m, i)
        if key not in self._chaos_nbr_cache:
            sched = self._chaos_sched
            if isinstance(sched.edge_masks, np.ndarray):   # dense topology
                row = np.asarray(self.topology.adjacency[i]) \
                    & sched.edge_masks[m, i]
                self._chaos_nbr_cache[key] = np.where(row)[0]
            else:
                nbr = self._chaos_nbr_table[i]
                alive = sched.slot_masks[m, i] & (nbr >= 0)
                self._chaos_nbr_cache[key] = nbr[alive]
        return self._chaos_nbr_cache[key]

    def _fire_ticks(self, phase: np.ndarray, order: np.ndarray, r: int
                    ) -> dict:
        """Round ``r``'s send sweep as ``{tick: [node, ...]}``, each list
        in the round's shuffled ``order``: a sync node fires at ``r delta
        + offset``, an async one at each multiple of its period in the
        round."""
        lo, hi = r * self.delta, (r + 1) * self.delta
        out: dict = {}
        for i in order.tolist():
            if self.sync:
                out.setdefault(lo + int(phase[i]), []).append(i)
            else:
                period = int(phase[i])
                for t in range(-(-lo // period) * period, hi, period):
                    out.setdefault(t, []).append(i)
        return out

    # -- the tick loop -------------------------------------------------------

    def start(self, state: SeqState, n_rounds: int = 10):
        """Run ``n_rounds * delta`` ticks on ``state`` (in place); returns
        the state and a report."""
        draws = self.draws
        # The tick loop counts from this call; the chaos schedule keys on
        # absolute rounds, so a chunked continuation meets the same
        # fault windows.
        round0 = int(state.round)
        seed, var_seed = draws.seq_host_seeds()
        rng = np.random.default_rng(seed)
        var_rng = np.random.default_rng(var_seed)
        if self._metric_names is None:
            self._metric_names = metric_names(self.handler, self.data,
                                              self.device)
        names = self._metric_names
        n, delta, dev = self.n_nodes, self.delta, self.device
        model = state.model
        handler = self.handler
        spans = self._spans
        msg_q: dict = {}   # tick -> [_Pending]; appended to mid-drain by
        rep_q: dict = {}   # zero-delay replies and reactions
        sent_pr = np.zeros(n_rounds, np.int64)
        failed_pr = np.zeros(n_rounds, np.int64)
        # The failure causes, column-compatible with the bulk engine's;
        # overflow stays zero (the queues are unbounded, as the
        # reference's).
        drop_pr = np.zeros(n_rounds, np.int64)
        offline_pr = np.zeros(n_rounds, np.int64)
        overflow_pr = np.zeros(n_rounds, np.int64)
        chaos_pr = np.zeros(n_rounds, np.int64)
        size_pr = np.zeros(n_rounds, np.int64)
        # Per-round device values, read when the run ends.
        dev_rows: dict = {}

        def keep(name, value):
            dev_rows.setdefault(name, []).append(value)

        probes = self.probes
        if probes is not None:
            B = probes.staleness_buckets
            acc_pr = np.zeros((n_rounds, n), np.int64)
            stale_sum_pr = np.zeros(n_rounds, np.int64)
            stale_max_pr = np.zeros(n_rounds, np.int64)
            stale_hist_pr = np.zeros((n_rounds, B), np.int64)
        sentinels = self.sentinels
        if sentinels is not None:
            hc = (self._health_carry if self._health_carry is not None
                  else HealthCarry.zeros(n, dev))
        # One counter feeds every event draw (handler calls, delay
        # samples, token reactions): no two events share a stream.
        event_counter = 0

        def next_event() -> int:
            nonlocal event_counter
            event_counter += 1
            return event_counter

        def orders(e: int):
            epochs = handler.orders_per_update()
            if epochs is None:
                return None
            split = handler.mode == CreateModelMode.UPDATE_MERGE
            return draws.event_orders(e, epochs, self.data["mtr"].shape[1],
                                      split).to(dev)

        def call(i: int, payload: PeerModel) -> ModelState:
            perms = orders(next_event())
            return handler.call(self._row(model, i), payload,
                                self._node_data[i], perms)

        def fire(failed: bool, rec: MessageRecord) -> None:
            for rx in self._receivers_list():
                rx.update_single_message(failed, rec)

        def schedule(rec: MessageRecord, payload, t: int,
                     is_reply: bool = False):
            """Drop or delay a message just sent; count and notify it.
            Replies count as sent at delivery, as the reference notifies
            them in its reply drain: a dropped reply only fails."""
            r = rec.round
            if not is_reply:
                sent_pr[r] += 1
                size_pr[r] += rec.size
                fire(False, rec)
            if rng.random() < self._drop_prob_at(round0 + r):
                failed_pr[r] += 1
                drop_pr[r] += 1
                fire(True, rec)
                return
            e = next_event()
            d = int(self.delay.sample(_EventDelayDraws(draws, e), r, 0, 1,
                                      rec.size, "cpu")[0])
            d = int(d * self._delay_scale_at(round0 + r))   # delay spike
            q = rep_q if is_reply else msg_q
            q.setdefault(t + d, []).append(_Pending(rec, payload, is_reply))

        msg_type = _PROTO_TO_MSG[self.protocol]
        is_pull = self.protocol == AntiEntropyProtocol.PULL
        send_size = 1 if is_pull else self._size   # a request carries no model

        def send_from(i: int, t: int, r: int):
            if self.variant == "cache_neigh" and self._cn_cache[i]:
                # Pop a random parked neighbour model and merge-update
                # with it before sending.
                senders = list(self._cn_cache[i])
                pick = senders[var_rng.integers(len(senders))]
                self._put(model, i, call(i, self._cn_cache[i].pop(pick)))
            nbrs = self._alive_nbrs(i, round0 + r)
            if len(nbrs) == 0:
                return   # isolated: skip (the reference aborts the sweep)
            peer = int(nbrs[rng.integers(len(nbrs))])
            payload = None if is_pull else self._peer_view(model, i)
            schedule(MessageRecord(t, r, i, peer, msg_type, send_size),
                     payload, t)

        merge_sq = train_sq = None

        def receive(p: _Pending, t: int, r: int,
                    is_online: np.ndarray) -> None:
            nonlocal merge_sq, train_sq
            i = p.rec.receiver
            if self.chaos is not None and self._forced_at(round0 + r)[i]:
                failed_pr[r] += 1   # a scheduled outage: the chaos cause
                chaos_pr[r] += 1
                fire(True, p.rec)
                return
            if not is_online[i]:
                failed_pr[r] += 1
                offline_pr[r] += 1
                fire(True, p.rec)
                return
            if p.is_reply:
                sent_pr[r] += 1
                size_pr[r] += p.rec.size
                fire(False, p.rec)
            carries_model = p.payload is not None
            wants_reply = p.rec.msg_type in (MessageType.PULL,
                                             MessageType.PUSH_PULL)
            if carries_model:
                if probes is not None:
                    # An accepted model-carrying merge: staleness in rounds
                    # since the payload was captured, clamped into the
                    # histogram's last bucket (ProbeAccum.record_slot).
                    stale = max(r - p.rec.round, 0)
                    acc_pr[r, i] += 1
                    stale_sum_pr[r] += stale
                    stale_max_pr[r] = max(stale_max_pr[r], stale)
                    stale_hist_pr[r, min(stale, B - 1)] += 1
                if self._probe_delta_ok:
                    before = self._row(model, i)
                    merged = handler._merge(before, p.payload)
                    new = call(i, p.payload)
                    m_sq = sq_param_distance(merged.params, before.params,
                                             spans).double()
                    t_sq = sq_param_distance(new.params, merged.params,
                                             spans).double()
                    merge_sq = m_sq if merge_sq is None else merge_sq + m_sq
                    train_sq = t_sq if train_sq is None else train_sq + t_sq
                    self._put(model, i, new)
                elif self.variant == "passthrough":
                    # Accept (merge and update) with probability min(1,
                    # deg_s / deg_r), else adopt the received model as it
                    # is; degrees of the static topology.
                    deg_r = max(int(self.topology.degrees[i]), 1)
                    deg_s = int(self.topology.degrees[p.rec.sender])
                    if var_rng.random() < min(1.0, deg_s / deg_r):
                        self._put(model, i, call(i, p.payload))
                    else:
                        model.params[i:i + 1].copy_(p.payload.params)
                        model.n_updates[i:i + 1].copy_(p.payload.n_updates)
                elif self.variant == "cache_neigh":
                    # Park (the latest per sender wins); popped and merged
                    # at the receiver's next send.
                    self._cn_cache[i][p.rec.sender] = p.payload
                else:
                    self._put(model, i, call(i, p.payload))
            if wants_reply and not p.is_reply:
                # The reply carries the receiver's current model, merges
                # of this tick included.
                rep = MessageRecord(t, r, i, p.rec.sender, MessageType.REPLY,
                                    self._size)
                schedule(rep, self._peer_view(model, i), t, is_reply=True)
            elif (self.account is not None and carries_model
                  and not p.is_reply):   # replies never react
                # A token reaction, this tick (it may cascade).
                util = float(self.utility_fun(self._row(model, i),
                                              p.payload))
                e = next_event()
                u = (torch.tensor([draws.event_uniform(e)])
                     if self.account.draws_reactive else None)
                k = int(self.account.reactive(
                    torch.tensor([int(state.balance[i])], dtype=torch.int32),
                    torch.tensor([util], dtype=torch.float32), u)[0])
                if k > 0:
                    # Every reaction is sent and the balance clamps at
                    # zero, as in the reference.
                    state.balance[i] = max(0, int(state.balance[i]) - k)
                    for _ in range(k):
                        send_from(i, t, r)

        def drain(q, t, r, is_online):
            # The live list: a zero-delay message scheduled mid-drain is
            # delivered this tick (the reference appends to the list it
            # iterates).
            pending = q.get(t, [])
            idx = 0
            while idx < len(pending):
                receive(pending[idx], t, r, is_online)
                idx += 1
            q.pop(t, None)

        for r in range(n_rounds):
            order = rng.permutation(n)
            fires = self._fire_ticks(state.phase, order, r)
            forced = (self._forced_at(round0 + r) if self.chaos is not None
                      else None)
            if sentinels is not None:
                pre_params = model.params.clone()   # round-start copy
            merge_sq = train_sq = None
            for t in range(r * delta, (r + 1) * delta):
                # (a) the send sweep, in the round's shuffled order.
                for i in fires.get(t, ()):
                    if forced is not None and forced[i]:
                        continue   # a scheduled outage: no sends either
                    if self.account is not None:
                        # state.balance is a host numpy array.
                        bal = int(state.balance[i])  # tracelint: disable=all
                        p = float(self.account.proactive(torch.tensor(
                            [bal], dtype=torch.int32))[0])
                        if rng.random() >= p:
                            state.balance[i] += 1   # bank a token
                            continue
                    send_from(i, t, r)
                # (b) the arrival drain, then (c) the reply drain.
                is_online = rng.random(n) <= self.online_prob
                drain(msg_q, t, r, is_online)
                drain(rep_q, t, r, is_online)
            # (d) the round boundary.
            idx = None
            if self.sampling_eval > 0:
                idx = torch.as_tensor(rng.choice(
                    n, max(int(n * self.sampling_eval), 1), replace=False),
                    device=dev)
            local, glob = population_metrics(handler, model.params,
                                             self.data, names, idx)
            keep("local", local)
            keep("global", glob)
            if self._probe_delta_ok:
                zero = torch.zeros((), dtype=torch.float64, device=dev)
                keep("merge_sq", zero if merge_sq is None else merge_sq)
                keep("train_sq", zero if train_sq is None else train_sq)
            if probes is not None and probes.consensus:
                cm, cx, cl = consensus_stats(model.params, spans)
                keep("probe_consensus_mean", cm)
                keep("probe_consensus_max", cx)
                keep("probe_consensus_per_layer", cl)
                if self.chaos is not None:
                    cs = chaos_round_stats(
                        model.params,
                        self._chaos_comp[self._chaos_row(round0 + r)],
                        self._chaos_ncomp, spans)
                    for k, v in cs.items():
                        keep(k, v)
            if sentinels is not None:
                hc, hstats = health_round_stats(
                    sentinels, hc, pre_params, model.params, local, glob,
                    spans)
                for k, v in hstats.items():
                    keep(k, v)
                self._health_carry = hc
            state.round += 1

        host = {k: torch.stack(v).cpu().numpy() for k, v in dev_rows.items()}
        local_rows = host["local"].astype(np.float32)
        global_rows = host["global"].astype(np.float32)
        extras: dict = {}
        if probes is not None:
            if probes.consensus:
                for k in ("probe_consensus_mean", "probe_consensus_max",
                          "probe_consensus_per_layer"):
                    extras[k] = host[k].astype(np.float64)
                extras["probe_layer_names"] = list(self._layer_names)
            if probes.staleness:
                counts = stale_hist_pr.sum(axis=1)
                extras["probe_stale_mean"] = (
                    stale_sum_pr / np.maximum(counts, 1)).astype(np.float64)
                extras["probe_stale_max"] = stale_max_pr
                extras["probe_stale_hist"] = stale_hist_pr
            if probes.mixing:
                extras["probe_accepted_per_node"] = acc_pr
                if self._probe_delta_ok:
                    extras["probe_merge_delta"] = np.sqrt(host["merge_sq"])
                    extras["probe_train_delta"] = np.sqrt(host["train_sq"])
                else:
                    nan_pr = np.full(n_rounds, np.nan)
                    extras["probe_merge_delta"] = nan_pr
                    extras["probe_train_delta"] = nan_pr.copy()
                extras["probe_expected_fanin"] = self._probe_expected_fanin()
        if self.chaos is not None and probes is not None \
                and probes.consensus:
            extras["chaos_component_gap"] = \
                host["chaos_component_gap"].astype(np.float64)
            extras["chaos_within_mean"] = \
                host["chaos_within_mean"].astype(np.float64)
            extras["chaos_active_components"] = \
                host["chaos_active_components"].astype(np.int64)
        if sentinels is not None:
            if sentinels.nonfinite:
                for k in ("health_nonfinite_params", "health_nonfinite_delta",
                          "health_nonfinite_metrics"):
                    extras[k] = host[k].astype(np.int64)
                extras["health_layer_names"] = list(self._layer_names)
            if sentinels.divergence:
                extras["health_diverged_per_node"] = \
                    host["health_diverged_per_node"].astype(np.int64)
                extras["health_param_norm_max"] = \
                    host["health_param_norm_max"].astype(np.float64)
            extras["health_delta_norm"] = \
                host["health_delta_norm"].astype(np.float64)
            extras["health_delta_hwm"] = \
                host["health_delta_hwm"].astype(np.float64)
            extras["health_trip"] = host["health_trip"].astype(np.int64)
        causes = {"drop": drop_pr, "offline": offline_pr,
                  "overflow": overflow_pr}
        if self.chaos is not None:
            causes["chaos"] = chaos_pr
        report = SimulationReport(
            metric_names=names,
            local_evals=local_rows if self.has_local_test else None,
            global_evals=global_rows if self.has_global_eval else None,
            sent=sent_pr, failed=failed_pr, total_size=int(size_pr.sum()),
            failed_by_cause=causes, **extras)
        self.replay_events(state.round - n_rounds, {
            "sent": sent_pr, "failed": failed_pr,
            "failed_drop": drop_pr, "failed_offline": offline_pr,
            "failed_overflow": overflow_pr, "size": size_pr,
            **({"failed_chaos": chaos_pr} if self.chaos is not None
               else {}),
            "local": local_rows, "global": global_rows,
            # The per-round probe and health arrays ride the same replay
            # (update_probes, update_health), the static context excluded.
            **{k: v for k, v in extras.items()
               if k not in ("probe_layer_names", "probe_expected_fanin",
                            "health_layer_names")}},
            names)
        return state, report

    def _probe_expected_fanin(self) -> np.ndarray:
        """``[N]`` expected accepted merges per node and round under
        uniform neighbour-list sampling, thinned by drop and online
        rates."""
        lam = np.zeros(self.n_nodes)
        for nb in self._nbrs:
            if len(nb):
                np.add.at(lam, np.asarray(nb), 1.0 / len(nb))
        return lam * (1.0 - self.drop_prob) * self.online_prob

    def run_repetitions(self, n_rounds: int, seeds, local_train: bool = True,
                        common_init: bool = False, draws=None
                        ) -> tuple[list, list]:
        """Independent runs, one after another: repetition ``i`` is
        :meth:`init_nodes` under ``torch.Generator().manual_seed(
        seeds[i])`` then :meth:`start`, drawing from ``draws[i]`` (default
        ``TorchDraws(seeds[i])``). Returns the final states and one report
        each; the simulator's own draw provider is restored afterwards."""
        if draws is not None and len(draws) != len(seeds):
            raise ValueError(f"{len(draws)} draw providers for "
                             f"{len(seeds)} repetitions")
        saved = self.draws
        states, reports = [], []
        try:
            for i, seed in enumerate(seeds):
                self.draws = (draws[i] if draws is not None
                              else TorchDraws(int(seed)))
                st = self.init_nodes(torch.Generator().manual_seed(int(seed)),
                                     local_train=local_train,
                                     common_init=common_init)
                st, rep = self.start(st, n_rounds=n_rounds)
                states.append(st)
                reports.append(rep)
        finally:
            self.draws = saved
        return states, reports
