"""The gossip simulation engine: the sync PUSH round.

Counterpart of ``gossipy_tpu/simulation/engine.py``. The JAX engine traces
a round into one XLA program; here a round is eager PyTorch on the run's
device, phase by phase:

    snapshot  the round-start params go into the ``[D, N, stride]``
              history ring, encoded in its wire format (``_snapshot``)
    send      every node draws one peer; drop draw; message metadata is
              scattered into the ``[D, N, K]`` mailbox (``_send_phase``)
    deliver   the cell's K slots are drained (``_deliver_phase``) by one of
              three paths, chosen by ``fused_merge``:
              - ``"multi"`` (the default): ONE launch of the multi-slot
                gather-merge kernel blends every live peer snapshot into
                its receiver, then ONE local update trains every node that
                received something;
              - ``"per_slot"``: per occupied slot, one launch of the
                single-slot gather-merge kernel, then one local update;
              - ``False`` (plain): per occupied slot, the peer snapshots
                are gathered and decoded, and the handler's ``call``
                (merge, then update) runs over the population, or, with
                compaction, over a gathered batch of the slot's live
                receivers;
              an empty slot skips its whole pass
    eval      local and global metrics, averaged over nodes (``_eval_phase``)

Messages carry node indices, not models: a message's payload is the
sender's row of the ring at its send round. The ring is stored in float32,
bfloat16 or int8 (``history_dtype``); an int8 ring keeps one float32 scale
per (ring cell, node, leaf) in ``history_scale``.

The state is updated in place: :meth:`GossipSimulator.start` mutates the
:class:`SimState` it is given and returns it.

Ported: PUSH, sync nodes, no delay, the three deliver paths with wide and
compact dispatch, the three ring formats. Every other option of the JAX
engine raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from .. import resolve_device
from ..core import AntiEntropyProtocol, ConstantDelay, CreateModelMode, \
    Delay, MessageType, Topology
from ..data import to_device
from ..handlers.base import ModelState, PeerModel
from ..ops.merge import column_leaves, gather_merge_flat, gather_merge_multi
from ..random import K_CALL, K_DROP, K_ONLINE, DrawProvider, TorchDraws
from ..telemetry import FailureCounts
from .report import SimulationReport

# Image rows one evaluation chunk may push through the model at once
# (nodes x eval samples): bounds the im2col buffers of the global eval.
EVAL_ROWS = 8192


class Mailbox(NamedTuple):
    """Ring-buffer mailbox: ``[D, N, K]`` int32 metadata per message slot."""

    sender: torch.Tensor      # sending node id, -1 = empty slot
    send_round: torch.Tensor  # round whose snapshot carries the payload
    msg_type: torch.Tensor    # MessageType value
    extra: torch.Tensor       # protocol-specific payload

    @staticmethod
    def empty(depth: int, n: int, k: int, device) -> "Mailbox":
        shape = (depth, n, k)
        z = lambda: torch.zeros(shape, dtype=torch.int32, device=device)
        return Mailbox(torch.full(shape, -1, dtype=torch.int32, device=device),
                       z(), z(), z())

    def clear_cell(self, b: int) -> None:
        """Empty cell ``b`` in place."""
        self.sender[b] = -1
        self.send_round[b] = 0
        self.msg_type[b] = 0
        self.extra[b] = 0


@dataclasses.dataclass
class SimState:
    """Full simulator state, updated in place round by round."""

    model: ModelState              # params [N, stride], n_updates [N]
    phase: torch.Tensor            # [N] int32 send offset within a round
    history_params: torch.Tensor   # [D, N, stride] round-start snapshots,
                                   # in the wire format
    history_ages: torch.Tensor     # [D, N] int32 snapshot ages
    mailbox: Mailbox
    round: int = 0
    history_scale: Optional[torch.Tensor] = None  # [D, N, L] f32, int8 only


def select_nodes(mask: torch.Tensor, a: ModelState,
                 b: ModelState) -> ModelState:
    """``mask ? a : b`` row by row."""
    return ModelState(torch.where(mask[:, None], a.params, b.params),
                      torch.where(mask, a.n_updates, b.n_updates))


def _take_rows(model: ModelState, idx: torch.Tensor) -> ModelState:
    return ModelState(model.params[idx], model.n_updates[idx])


def _put_rows(model: ModelState, idx: torch.Tensor,
              part: ModelState) -> ModelState:
    """``model`` with rows ``idx`` replaced by ``part`` (a new state)."""
    return ModelState(model.params.index_copy(0, idx, part.params),
                      model.n_updates.index_copy(0, idx, part.n_updates))


def _rank_within_group(key: torch.Tensor) -> torch.Tensor:
    """For each element, its 0-based rank among equal values of ``key``
    (in index order)."""
    n = key.shape[0]
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]
    pos = torch.arange(n, device=key.device)
    is_start = torch.ones(n, dtype=torch.bool, device=key.device)
    is_start[1:] = sorted_key[1:] != sorted_key[:-1]
    group_start = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - group_start
    return rank


class GossipSimulator:
    """Vanilla gossip simulator.

    Parameters follow ``gossipy_tpu.simulation.GossipSimulator``; those the
    port has not taken over raise ``NotImplementedError`` when set to
    anything but their default. Differences:

    fused_merge : False | "multi" | True | "per_slot"
        The deliver path (``True`` means ``"multi"``). The default is
        ``"multi"``, where the JAX engine's is ``False``.
    compact_deliver : None | bool | int
        As in the JAX engine: ``None`` turns compaction on for the plain
        path at N >= 48 with K > 1; ``True`` derives the capacity; an int
        sets it. The ``"per_slot"`` path takes no compaction.
    history_dtype : "float32" | "bfloat16" | "int8"
        The ring's wire format.
    draws : DrawProvider | None
        Source of every random draw of the run (default
        :class:`~gossipy_tpu_torch.random.TorchDraws` seeded with 42).
    device : str | torch.device | None
        ``cuda`` unless ``"cpu"`` is passed; raises without a card.
    """

    _SLOT_FLOOR = 6
    _SLOT_CAP = 64
    _HISTORY_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                       "int8": torch.int8}

    def __init__(self,
                 handler,
                 topology: Topology,
                 data: dict,
                 delta: int = 100,
                 protocol: AntiEntropyProtocol = AntiEntropyProtocol.PUSH,
                 drop_prob: float = 0.0,
                 online_prob: float = 1.0,
                 delay: Delay = ConstantDelay(0),
                 sampling_eval: float = 0.0,
                 eval_every: int = 1,
                 sync: bool = True,
                 mailbox_slots: Optional[int] = None,
                 message_size: Optional[int] = None,
                 fused_merge: Union[bool, str] = "multi",
                 compact_deliver: Union[None, bool, int] = None,
                 mesh=None,
                 max_fires_per_round: Optional[int] = None,
                 history_dtype: str = "float32",
                 probes=None,
                 sentinels=None,
                 chaos=None,
                 perf=None,
                 metrics=None,
                 cohort=None,
                 tracing=None,
                 ledger=None,
                 draws: Optional[DrawProvider] = None,
                 device=None):
        if not (0 <= drop_prob < 1 and 0 < online_prob <= 1):
            raise ValueError("need 0 <= drop_prob < 1 and 0 < online_prob <= 1")
        if history_dtype not in self._HISTORY_DTYPES:
            raise ValueError(f"unknown history_dtype {history_dtype!r}; "
                             "options: " + ", ".join(self._HISTORY_DTYPES))
        unported = {"mesh": mesh, "probes": probes, "sentinels": sentinels,
                    "chaos": chaos, "perf": perf, "metrics": metrics,
                    "cohort": cohort, "tracing": tracing, "ledger": ledger}
        for name, val in unported.items():
            if val is not None:
                raise NotImplementedError(f"{name}= is not ported yet")
        if fused_merge is True:
            fused_merge = "multi"
        elif not fused_merge:
            fused_merge = False
        elif fused_merge not in ("multi", "per_slot"):
            raise ValueError(f"unknown fused_merge mode {fused_merge!r}; "
                             "options: False, True/'multi', 'per_slot'")
        if protocol != AntiEntropyProtocol.PUSH:
            raise NotImplementedError(f"{protocol!r} is not ported yet (PUSH)")
        if not sync or (max_fires_per_round not in (None, 1)):
            raise NotImplementedError("async nodes are not ported yet")
        if not isinstance(delay, ConstantDelay) or delay.delay != 0:
            raise NotImplementedError("message delays are not ported yet "
                                      "(ConstantDelay(0) only)")
        if sampling_eval > 0:
            raise NotImplementedError("sampling_eval is not ported yet")
        if eval_every < 1:
            raise ValueError("eval_every must be >= 1")
        if fused_merge:
            # The fused kernels replace the merge with a fixed two-way
            # blend: only a uniform-average MERGE_UPDATE handler that
            # declares its blend coefficient may take them.
            if not getattr(handler, "uniform_avg_merge", False):
                raise ValueError("fused_merge requires a uniform-average "
                                 "merge handler")
            if getattr(handler, "merge_peer_weight", None) is None:
                raise ValueError("fused_merge requires the handler to "
                                 "declare its blend coefficient "
                                 "(merge_peer_weight)")
            if handler.mode != CreateModelMode.MERGE_UPDATE:
                raise ValueError("fused_merge only fuses the MERGE_UPDATE "
                                 "path")
        elif handler.mode == CreateModelMode.UPDATE_MERGE:
            raise NotImplementedError(
                "CreateModelMode.UPDATE_MERGE is not ported yet")

        self.device = resolve_device(device)
        self.handler = handler
        self.topology = topology
        self.n_nodes = topology.num_nodes
        self.delta = int(delta)
        self.drop_prob = float(drop_prob)
        self.online_prob = float(online_prob)
        self.delay = delay
        self.eval_every = int(eval_every)
        self.fused_merge = fused_merge
        self.history_dtype = history_dtype
        self.F = 1
        self._lam_vec: Optional[np.ndarray] = None
        self.K = (self._derive_mailbox_slots(self._lam_max())
                  if mailbox_slots is None else int(mailbox_slots))
        self._warn_if_mailbox_undersized()
        self._compact_cap = self._compact_capacity(compact_deliver)
        self._message_size = message_size
        self.draws = draws if draws is not None else TorchDraws(42)
        self.data = to_device(data, self.device)
        self.has_local_test = "xte" in self.data
        self.has_global_eval = "x_eval" in self.data
        self._adj = topology.adjacency_on(self.device)
        self._metric_names: Optional[list] = None
        # The leaves of the flat row: start columns (the kernels' leaf
        # table) and each column's leaf (the int8 codec's scale lookup;
        # padding columns take the last leaf's).
        layout = handler.layout
        starts = [layout.offsets[name] for name, _ in layout.leaves]
        self._leaf_spans = [(layout.offsets[name], math.prod(shape))
                            for name, shape in layout.leaves]
        self._leaf_starts = torch.tensor(starts, dtype=torch.int32,
                                         device=self.device)
        self._col_leaf = column_leaves(starts, layout.stride, self.device)

    # -- mailbox sizing and compaction ------------------------------------

    def _lam_vector(self) -> np.ndarray:
        """Per-node expected same-round fan-in under uniform peer draws:
        ``lam_i = sum_{j -> i} F / deg_j`` (computed once)."""
        if self._lam_vec is None:
            deg = np.maximum(self.topology.degrees.astype(np.float64), 1.0)
            self._lam_vec = np.asarray((self.F / deg)
                                       @ self.topology.adjacency,
                                       dtype=np.float64)
        return self._lam_vec

    def _lam_max(self) -> float:
        """Worst-case expected same-round fan-in."""
        return float(self._lam_vector().max()) if self.n_nodes else 0.0

    @staticmethod
    def _poisson_tail(lam: float, k: int) -> float:
        """P(Poisson(lam) > k), summed in log space."""
        if lam <= 0.0:
            return 0.0
        logs = [-lam + x * math.log(lam) - math.lgamma(x + 1)
                for x in range(k + 1)]
        m = max(logs)
        cdf = math.exp(m) * sum(math.exp(v - m) for v in logs)
        return min(max(1.0 - cdf, 0.0), 1.0)

    def _derive_mailbox_slots(self, lam_max: float) -> int:
        """Smallest K whose per-node-round overflow is under 1e-3, within
        [_SLOT_FLOOR, _SLOT_CAP]."""
        k = self._SLOT_FLOOR
        while k < self._SLOT_CAP and self._poisson_tail(lam_max, k) > 1e-3:
            k += 1
        return k

    def _warn_if_mailbox_undersized(self) -> None:
        lam_max = self._lam_max()
        p_over = self._poisson_tail(lam_max, self.K) if lam_max > 0 else 0.0
        if p_over > 1e-3:
            warnings.warn(
                f"mailbox_slots={self.K} may overflow on this topology: "
                f"worst-case expected same-round fan-in {lam_max:.1f} gives "
                f"~{p_over:.1%} per-node-round message loss (counted as "
                "'failed'). Raise mailbox_slots to silence.")

    def _compact_capacity(self, compact_deliver) -> Optional[int]:
        """The compacted pass's static receiver capacity, or None when
        compaction is off (the rules of engine.py:659-709)."""
        if compact_deliver is None:
            compact_deliver = (not self.fused_merge and self.n_nodes >= 48
                               and self.K > 1)
        elif compact_deliver and self.fused_merge == "per_slot":
            raise ValueError("compact_deliver composes with the single-pass "
                             "fused deliver (fused_merge='multi') but not "
                             "the per-slot fused path")
        if not compact_deliver:
            return None
        if not isinstance(compact_deliver, bool):
            # An explicit capacity: overflow still falls back to the wide
            # pass, so any positive value is correct.
            if int(compact_deliver) < 1:
                raise ValueError("compact_deliver capacity must be >= 1, got "
                                 f"{compact_deliver} (use False/None to "
                                 "disable)")
            return min(int(compact_deliver), self.n_nodes)
        if self.K == 1:
            warnings.warn("compact_deliver=True has no effect with "
                          "mailbox_slots=1 (slot 0 always overflows the "
                          "derived capacity); disabled. Pass an explicit "
                          "integer capacity to force it.")
            return None
        return self._derive_compact_cap()

    def _derive_compact_cap(self) -> Optional[int]:
        """Receiver capacity of the compacted pass, sized for slots >= 1:
        the count of nodes with a second same-round arrival, mean + 3
        sigma + 4 of independent indicators with ``p2_i = P(Poisson(lam_i)
        >= 2)`` (thinned by drops, times the online rate), rounded up to a
        multiple of 8. None when it would not beat the wide pass."""
        n = self.n_nodes
        lam = self._lam_vector() * (1.0 - self.drop_prob)
        p2 = np.clip(-np.expm1(-lam) - lam * np.exp(-lam), 0.0, 1.0)
        p2 *= self.online_prob
        cap = p2.sum() + 3.0 * float(np.sqrt((p2 * (1.0 - p2)).sum())) + 4.0
        cap = int(-(-cap // 8) * 8)
        cap = max(cap, 8)
        if cap >= 0.75 * n:
            return None
        return cap

    # -- history wire format ------------------------------------------------

    def _wire_itemsize(self) -> int:
        """Bytes per stored history scalar under the configured format."""
        return {"float32": 4, "bfloat16": 2, "int8": 1}[self.history_dtype]

    def _encode_history_rows(self, params: torch.Tensor):
        """Encode flat rows ``[..., N, stride]`` into the wire format.
        Returns ``(stored, scales)``: ``scales`` is ``[..., N, L]`` float32
        for int8 (one per row and leaf), else None. float32 is the
        identity.

        int8 is symmetric, as in the JAX package (engine.py:1179-1192):
        ``s = amax / 127`` over the leaf (1 for an all-zero leaf),
        ``q = clip(round(x / s), -127, 127)`` with a true division and
        round-half-to-even. Padding columns are 0 and stay 0."""
        if self.history_dtype == "float32":
            return params, None
        if self.history_dtype == "bfloat16":
            return params.to(torch.bfloat16), None
        amax = torch.stack([params[..., o:o + w].abs().amax(dim=-1)
                            for o, w in self._leaf_spans], dim=-1)
        scales = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        q = torch.round(params.to(torch.float32) / scales[..., self._col_leaf])
        return q.clamp(-127, 127).to(torch.int8), scales

    def _decode_history_rows(self, stored: torch.Tensor,
                             scales: Optional[torch.Tensor]) -> torch.Tensor:
        """Inverse of :meth:`_encode_history_rows`, float32 out."""
        if self.history_dtype == "float32":
            return stored
        if self.history_dtype == "bfloat16":
            return stored.to(torch.float32)
        return stored.to(torch.float32) * scales[..., self._col_leaf]

    def _wire_roundtrip(self, params: torch.Tensor) -> torch.Tensor:
        """What a receiver sees of ``params`` after transport: encode, then
        decode."""
        return self._decode_history_rows(*self._encode_history_rows(params))

    def wire_bytes_per_message(self) -> int:
        """Bytes one model-carrying message moves under the wire format:
        the payload plus, for int8, one float32 scale per leaf (the
        scalars the JAX package counts; the port's row padding is not
        sent)."""
        layout = self.handler.layout
        sidecar = 4 * len(layout.leaves) if self.history_dtype == "int8" \
            else 0
        return layout.width * self._wire_itemsize() + sidecar

    # -- state -------------------------------------------------------------

    def _local_data(self):
        return (self.data["xtr"], self.data["ytr"], self.data["mtr"])

    def _model_size(self) -> int:
        if self._message_size is not None:
            return self._message_size
        return int(self.handler.get_size())

    def _history_depth(self, size: int) -> int:
        """Ring depth covering the worst in-flight delay (2 at delay 0)."""
        max_d = self.delay.max_delay(size)
        return max(2, (self.delta - 1 + 2 * max_d) // self.delta + 2)

    def init_nodes(self, generator: Optional[torch.Generator] = None,
                   local_train: bool = True,
                   common_init: bool = False) -> SimState:
        """Initialise every node's model (weights from ``generator``,
        default seeded with 0), then one local pre-training pass.

        ``common_init=True`` gives every node the same initial weights; the
        pre-training pass still diversifies them.
        """
        n = self.n_nodes
        g = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        if common_init:
            one = self.handler.init(g, self.device).params
            params = one.unsqueeze(0).repeat(n, 1)
        else:
            params = torch.stack([self.handler.init(g, self.device).params
                                  for _ in range(n)])
        model = ModelState(params, torch.zeros(n, dtype=torch.int32,
                                               device=self.device))
        if local_train:
            s = self.data["mtr"].shape[1]
            perms = self.draws.init_permutations(
                n, self.handler.local_epochs, s, self.device)
            model = self.handler.update(model, self._local_data(), perms)
        phase = self.draws.init_phase(n, self.delta, self.device)
        return self.init_state(model, phase)

    def init_state(self, model: ModelState, phase: torch.Tensor) -> SimState:
        """A round-0 state around given node models: the ring holds
        ``model``'s params, encoded, in every cell and the mailbox is
        empty."""
        n = self.n_nodes
        params = model.params.to(self.device, torch.float32).contiguous()
        n_updates = model.n_updates.to(self.device, torch.int32)
        D = self._history_depth(self._model_size())
        stored, scales = self._encode_history_rows(params)
        return SimState(
            model=ModelState(params, n_updates),
            phase=phase.to(self.device, torch.int32),
            history_params=stored.unsqueeze(0).repeat(D, 1, 1),
            history_ages=n_updates.unsqueeze(0).repeat(D, 1),
            mailbox=Mailbox.empty(D, n, self.K, self.device),
            history_scale=(None if scales is None
                           else scales.unsqueeze(0).repeat(D, 1, 1)),
        )

    # -- per-round phases --------------------------------------------------

    def _snapshot(self, state: SimState, r: int) -> None:
        b = r % state.history_ages.shape[0]
        stored, scales = self._encode_history_rows(state.model.params)
        state.history_params[b].copy_(stored)
        state.history_ages[b].copy_(state.model.n_updates)
        if scales is not None:
            state.history_scale[b].copy_(scales)

    def _scatter_messages(self, box: Mailbox, active, dr, recv, sender_ids,
                          send_round: int, msg_type: int, extra, r: int,
                          slots_cap: int):
        """Allocate slots and write message metadata into ``box`` in place.
        Slot = the target cell's occupancy + the message's rank among this
        batch's messages for the same cell; a message past the last slot
        overflows. Returns the overflow count."""
        D, n, _ = box.sender.shape
        b = (r + dr) % D
        recv_c = recv.clamp(0, n - 1)
        cell_key = torch.where(active, b * n + recv_c,
                               torch.full_like(recv_c, D * n + 7))
        rank = _rank_within_group(cell_key)
        occ = (box.sender >= 0).sum(dim=2)
        slot = occ[b, recv_c] + rank
        ok = active & (slot < slots_cap)
        n_overflow = (active & (slot >= slots_cap)).sum()
        where = (b[ok], recv_c[ok], slot[ok])
        box.sender[where] = sender_ids[ok].to(torch.int32)
        box.send_round[where] = send_round
        box.msg_type[where] = msg_type
        box.extra[where] = extra[ok].to(torch.int32)
        return n_overflow

    def _send_phase(self, state: SimState, r: int):
        n = self.n_nodes
        dev = self.device
        size = self._model_size()
        peers = self.draws.peers(r, self._adj)
        active = peers >= 0  # sync nodes fire once per round
        dropped = self.draws.bernoulli(r, K_DROP, self.drop_prob, n, dev)
        delays = self.delay.sample(n, size, dev)
        dr = (state.phase.long() + delays) // self.delta
        n_sent = active.sum()
        fails = FailureCounts(drop=(active & dropped).sum())
        live = active & ~dropped
        n_overflow = self._scatter_messages(
            state.mailbox, live, dr, peers, torch.arange(n, device=dev), r,
            int(MessageType.PUSH), torch.zeros(n, dtype=torch.int32,
                                               device=dev), r, self.K)
        fails = fails._replace(overflow=n_overflow)
        return n_sent, fails, n_sent * size

    # -- deliver: the ring ----------------------------------------------------

    def _ring(self, state: SimState):
        """The ring as the kernels address it: ``[D*N, stride]`` rows in
        the wire format, and for int8 the ``[D*N, L]`` scales and the leaf
        start columns (else None, None)."""
        h = state.history_params
        ring = h.view(-1, h.shape[-1])
        if state.history_scale is None:
            return ring, None, None
        sc = state.history_scale
        return ring, sc.view(-1, sc.shape[-1]), self._leaf_starts

    def _gather_peer(self, state: SimState, send_round: torch.Tensor,
                     sender: torch.Tensor) -> PeerModel:
        """The snapshots messages carry: ``history[send_round % D][sender]``,
        decoded from the ring's wire format to float32."""
        D = state.history_ages.shape[0]
        cell = send_round.long() % D
        s = sender.long().clamp(0, self.n_nodes - 1)
        scales = (None if state.history_scale is None
                  else state.history_scale[cell, s])
        params = self._decode_history_rows(state.history_params[cell, s],
                                           scales)
        return PeerModel(params, state.history_ages[cell, s])

    # -- deliver: the plain and per-slot paths (the slot loop) ---------------

    def _delivery_path_counts(self, n_live: int) -> tuple[int, int]:
        """(compact, wide) 0/1 indicators of one slot's pass, from the
        slot's live receiver count, as :meth:`_receive_slot_apply`
        dispatches it."""
        if n_live == 0:
            return 0, 0
        if self._compact_cap is not None and n_live <= self._compact_cap:
            return 1, 0
        return 0, 1

    def _slot_loop(self, state: SimState, r: int, sr_t, sender_t,
                   apply_t) -> tuple[int, int]:
        """One pass per occupied mailbox slot, in slot order; slot ``k``
        trains every node under purpose ``K_CALL * 101 + k``. Returns the
        (compact, wide) slot counts."""
        n = self.n_nodes
        live = apply_t.sum(dim=0).tolist()
        first_k = torch.zeros(n, dtype=torch.int64, device=self.device)
        n_compact = n_wide = 0
        for k, n_live in enumerate(live):
            dc, dw = self._delivery_path_counts(n_live)
            n_compact += dc
            n_wide += dw
            if n_live == 0:
                continue
            perms = self.draws.update_permutations(
                r, [K_CALL * 101 + k], first_k, self.handler.local_epochs,
                self.data["mtr"].shape[1])
            self._receive_slot_apply(state, sr_t[:, k], sender_t[:, k],
                                     apply_t[:, k], perms, n_live)
        return n_compact, n_wide

    def _receive_slot_apply(self, state: SimState, send_round, sender, valid,
                            perms, n_live: int) -> None:
        """One mailbox slot: the per-slot fused kernel, the compacted pass
        when every live receiver fits the capacity, else the wide pass."""
        if self.fused_merge:
            self._fused_receive(state, send_round, sender, valid, perms)
        elif self._compact_cap is not None and n_live <= self._compact_cap:
            self._apply_receive_compact(state, send_round, sender, valid,
                                        perms)
        else:
            self._apply_receive_wide(state, send_round, sender, valid, perms)

    def _apply_receive_wide(self, state: SimState, send_round, sender, valid,
                            perms) -> None:
        peer = self._gather_peer(state, send_round, sender)
        self._apply_receive(state, peer, valid, perms)

    def _apply_receive(self, state: SimState, peer: PeerModel, valid,
                       perms) -> None:
        """Population-wide :meth:`_receive_rows`, kept where ``valid``."""
        new_model = self._receive_rows(state.model, peer, self._local_data(),
                                       perms)
        state.model = select_nodes(valid, new_model, state.model)

    def _apply_receive_compact(self, state: SimState, send_round, sender,
                               valid, perms) -> None:
        """The receive pass over a gathered batch of ``cap`` rows that holds
        every live receiver (the stable valid-first argsort), with each
        node's own shard orders; only called when the live count fits."""
        idx = torch.argsort((~valid).to(torch.int32),
                            stable=True)[:self._compact_cap]
        sub_valid = valid[idx]
        peer = self._gather_peer(state, send_round[idx], sender[idx])
        sub_model = _take_rows(state.model, idx)
        data = tuple(d[idx] for d in self._local_data())
        new_sub = self._receive_rows(sub_model, peer, data, perms[idx])
        new_sub = select_nodes(sub_valid, new_sub, sub_model)
        state.model = _put_rows(state.model, idx, new_sub)

    def _receive_rows(self, models: ModelState, peer: PeerModel, data,
                      perms) -> ModelState:
        """The handler's receive over row-aligned batches (the population,
        or a gathered subset)."""
        return self.handler.call(models, peer, data, perms)

    def _fused_receive(self, state: SimState, send_round, sender, valid,
                       perms) -> None:
        """MERGE_UPDATE through the single-slot gather-merge kernel (one
        launch over the flat row, where the JAX engine launches once per
        leaf), then the local update of every node; rows without a live
        message keep their state."""
        n = self.n_nodes
        D = state.history_ages.shape[0]
        s = sender.long().clamp(0, n - 1)
        cell = send_round.long() % D
        w_peer = torch.where(valid, float(self.handler.merge_peer_weight),
                             0.0).to(torch.float32)
        w_self = 1.0 - w_peer
        ring, scale, starts = self._ring(state)
        model = state.model
        merged = gather_merge_flat(model.params, ring, cell * n + s, w_self,
                                   w_peer, scale, starts)
        ages = torch.maximum(model.n_updates, state.history_ages[cell, s])
        updated = self.handler.update(ModelState(merged, ages),
                                      self._local_data(), perms)
        state.model = select_nodes(valid, updated, model)

    # -- deliver: the single-pass fused path ----------------------------------

    def _fused_multi_tables(self, state: SimState, sr_t, sender_t, apply_t):
        """The ``[rows, K]`` kernel tables of one mailbox cell: flat ring
        indices, blend weights (``(1, 0)`` for empty slots) and peer
        ages."""
        n = self.n_nodes
        D = state.history_ages.shape[0]
        s = sender_t.long().clamp(0, n - 1)
        cell = sr_t.long() % D
        flat_idx = cell * n + s
        w_peer = torch.where(apply_t, float(self.handler.merge_peer_weight),
                             0.0).to(torch.float32)
        w_self = 1.0 - w_peer
        peer_ages = state.history_ages[cell, s]
        return flat_idx, w_self, w_peer, peer_ages

    def _fused_multi_merge_update(self, state: SimState, model: ModelState,
                                  sr_t, sender_t, apply_t, perms, row_valid,
                                  data) -> ModelState:
        """One kernel launch and one update over ``model``'s rows: the
        compound left-to-right K-slot blend, age = max over the live
        peers, then the local update; rows without a live message keep
        their state."""
        flat_idx, w_self, w_peer, peer_ages = self._fused_multi_tables(
            state, sr_t, sender_t, apply_t)
        ring, scale, starts = self._ring(state)
        merged = gather_merge_multi(model.params, ring, flat_idx, w_self,
                                    w_peer, scale, starts)
        live_ages = torch.where(apply_t, peer_ages,
                                torch.zeros_like(peer_ages)).amax(dim=1)
        ages = torch.maximum(model.n_updates, live_ages)
        updated = self.handler.update(ModelState(merged, ages), data, perms)
        return select_nodes(row_valid, updated, model)

    def _fused_multi_apply(self, state: SimState, sr_t, sender_t, apply_t,
                           perms, any_msg) -> None:
        state.model = self._fused_multi_merge_update(
            state, state.model, sr_t, sender_t, apply_t, perms, any_msg,
            self._local_data())

    def _fused_multi_apply_compact(self, state: SimState, sr_t, sender_t,
                                   apply_t, perms, any_msg) -> None:
        """The single pass over ``cap`` gathered rows holding every
        receiver with a live message (the stable valid-first argsort)."""
        idx = torch.argsort((~any_msg).to(torch.int32),
                            stable=True)[:self._compact_cap]
        data = tuple(d[idx] for d in self._local_data())
        new_sub = self._fused_multi_merge_update(
            state, _take_rows(state.model, idx), sr_t[idx], sender_t[idx],
            apply_t[idx], perms[idx], any_msg[idx], data)
        state.model = _put_rows(state.model, idx, new_sub)

    def _fused_multi_dispatch(self, state: SimState, sr_t, sender_t, apply_t,
                              perms, any_msg, n_live: int,
                              occ_slots: int) -> tuple[int, int]:
        """The compacted single pass when every receiver fits the capacity,
        else the wide one; returns ``(compact, wide)`` with the cell's
        occupied-slot count on the path taken."""
        if self._compact_cap is not None and n_live <= self._compact_cap:
            self._fused_multi_apply_compact(state, sr_t, sender_t, apply_t,
                                            perms, any_msg)
            return occ_slots, 0
        self._fused_multi_apply(state, sr_t, sender_t, apply_t, perms,
                                any_msg)
        return 0, occ_slots

    def _fused_deliver_all(self, state: SimState, r: int, sr_t, sender_t,
                           apply_t) -> tuple[int, int]:
        """Single-pass fused deliver of one mailbox cell; each node trains
        under its first live slot's stream. Returns the (compact, wide)
        slot counts."""
        any_msg = apply_t.any(dim=1)
        n_live, occ_slots = torch.stack(
            [any_msg.sum(), apply_t.any(dim=0).sum()]).tolist()
        if n_live == 0:
            return 0, 0
        first_k = torch.argmax(apply_t.to(torch.int32), dim=1)
        perms = self.draws.update_permutations(
            r, [K_CALL * 101 + k for k in range(self.K)], first_k,
            self.handler.local_epochs, self.data["mtr"].shape[1])
        return self._fused_multi_dispatch(state, sr_t, sender_t, apply_t,
                                          perms, any_msg, n_live, occ_slots)

    def _deliver_phase(self, state: SimState, r: int):
        """Deliver this round's mailbox cell; returns the failure counts
        and the diagnostics of the cell."""
        n = self.n_nodes
        D = state.history_ages.shape[0]
        b = r % D
        box = state.mailbox
        online = self.draws.bernoulli(r, K_ONLINE, self.online_prob, n,
                                      self.device)
        sender_t = box.sender[b]
        sr_t = box.send_round[b]
        ty_t = box.msg_type[b]
        occupied_t = sender_t >= 0
        hwm = occupied_t.sum(dim=1).max()
        carries = ((ty_t == MessageType.PUSH) | (ty_t == MessageType.PUSH_PULL)
                   | (ty_t == MessageType.REPLY))
        apply_t = occupied_t & online[:, None] & carries
        fails = FailureCounts(offline=(occupied_t & ~online[:, None]).sum())
        if self.fused_merge == "multi":
            n_compact, n_wide = self._fused_deliver_all(state, r, sr_t,
                                                        sender_t, apply_t)
        else:
            n_compact, n_wide = self._slot_loop(state, r, sr_t, sender_t,
                                                apply_t)
        box.clear_cell(b)
        return fails, {"mailbox_hwm": hwm, "compact_slots": n_compact,
                       "wide_slots": n_wide}

    # -- evaluation --------------------------------------------------------

    def _metric_keys(self) -> list:
        if self._metric_names is None:
            key = "xte" if self.has_local_test else "xtr"
            ykey, mkey = "y" + key[1:], "m" + key[1:]
            d = (self.data[key][:1, :1], self.data[ykey][:1, :1],
                 self.data[mkey][:1, :1])
            params = self.handler.init(torch.Generator().manual_seed(0),
                                       self.device).params
            res = self.handler.evaluate(ModelState(params[None], None), d)
            self._metric_names = sorted(res.keys())
        return self._metric_names

    def _mean_metrics(self, res: dict, node_mask: torch.Tensor):
        vals = torch.stack([res[k] for k in self._metric_keys()], dim=-1)
        w = node_mask.to(torch.float32)
        tot = w.sum()
        mean = (vals * w[:, None]).sum(0) / torch.clamp(tot, min=1.0)
        return torch.where(tot > 0, mean, torch.full_like(mean, float("nan")))

    @torch.no_grad()
    def _eval_phase(self, state: SimState):
        names = self._metric_keys()
        nan = torch.full((len(names),), float("nan"), device=self.device)
        model = state.model
        local = nan
        if self.has_local_test:
            d = (self.data["xte"], self.data["yte"], self.data["mte"])
            res = self.handler.evaluate(model, d)
            local = self._mean_metrics(res, self.data["mte"].sum(dim=1) > 0)
        glob = nan
        if self.has_global_eval:
            xe, ye = self.data["x_eval"], self.data["y_eval"]
            me = torch.ones(xe.shape[0], device=self.device)
            chunk = max(1, EVAL_ROWS // max(1, xe.shape[0]))
            parts = []
            for lo in range(0, self.n_nodes, chunk):
                p = model.params[lo:lo + chunk]
                c = p.shape[0]
                d = (xe.expand(c, *xe.shape), ye.expand(c, *ye.shape),
                     me.expand(c, *me.shape))
                parts.append(self.handler.evaluate(ModelState(p, None), d))
            res = {k: torch.cat([r[k] for r in parts]) for k in names}
            glob = self._mean_metrics(
                res, torch.ones(self.n_nodes, dtype=torch.bool,
                                device=self.device))
        return local, glob

    def _maybe_eval(self, state: SimState, r: int, last_round=None):
        """``_eval_phase`` every ``eval_every`` rounds and on the run's last
        round; NaN rows otherwise."""
        due = (r + 1) % self.eval_every == 0 or r == last_round
        if due:
            return self._eval_phase(state)
        nan = torch.full((len(self._metric_keys()),), float("nan"),
                         device=self.device)
        return nan, nan

    # -- the round ---------------------------------------------------------

    def _round(self, state: SimState, last_round=None) -> dict:
        """One round, in place; returns the round's stats (0-d tensors and
        metric rows, still on the device)."""
        r = state.round
        self._snapshot(state, r)
        n_sent, fail_s, size = self._send_phase(state, r)
        fail_d, diag = self._deliver_phase(state, r)
        local, glob = self._maybe_eval(state, r, last_round)
        state.round = r + 1
        fails = fail_s + fail_d
        return {
            "sent": n_sent,
            "failed": fails.total(),
            "failed_drop": fails.drop,
            "failed_offline": fails.offline,
            "failed_overflow": fails.overflow,
            "mailbox_hwm": diag["mailbox_hwm"],
            "compact_slots": diag["compact_slots"],
            "wide_slots": diag["wide_slots"],
            "size": size,
            "local": local,
            "global": glob,
        }

    def start(self, state: SimState, n_rounds: int = 100
              ) -> tuple[SimState, SimulationReport]:
        """Run ``n_rounds`` rounds on ``state`` (in place); returns the
        state and a report. The per-round counters stay on the device
        until the run ends."""
        last = state.round + n_rounds - 1
        rows = [self._round(state, last) for _ in range(n_rounds)]
        stats = {}
        for k in rows[0] if rows else ():
            vals = [torch.as_tensor(row[k], device=self.device) for row in rows]
            stats[k] = torch.stack(vals).cpu().numpy()
        return state, self._build_report(stats, n_rounds)

    def _build_report(self, stats: dict, n_rounds: int) -> SimulationReport:
        m = len(self._metric_keys())
        empty_i = np.zeros((n_rounds,), np.int64)

        def get(k, default):
            return stats.get(k, default)
        return SimulationReport(
            metric_names=self._metric_keys(),
            local_evals=(get("local", np.zeros((0, m)))
                         if self.has_local_test else None),
            global_evals=(get("global", np.zeros((0, m)))
                          if self.has_global_eval else None),
            sent=get("sent", empty_i),
            failed=get("failed", empty_i),
            total_size=int(np.asarray(get("size", empty_i)).sum()),
            failed_by_cause={"drop": get("failed_drop", empty_i),
                             "offline": get("failed_offline", empty_i),
                             "overflow": get("failed_overflow", empty_i)},
            mailbox_hwm=get("mailbox_hwm", empty_i),
            compact_slots=get("compact_slots", empty_i),
            wide_slots=get("wide_slots", empty_i),
        )
