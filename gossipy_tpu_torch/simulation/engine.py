"""The gossip simulation engine: the sync PUSH round with the single-pass
fused deliver.

Counterpart of ``gossipy_tpu/simulation/engine.py``. The JAX engine traces
a round into one XLA program; here a round is eager PyTorch on the run's
device, phase by phase:

    snapshot  the round-start params go into the ``[D, N, stride]``
              history ring (``_snapshot``)
    send      every node draws one peer; drop draw; message metadata is
              scattered into the ``[D, N, K]`` mailbox (``_send_phase``)
    deliver   the cell's K slots become ``[N, K]`` tables; ONE launch of
              the gather-merge kernel blends every live peer snapshot into
              its receiver, then ONE local update trains every node that
              received something (``_deliver_phase``)
    eval      local and global metrics, averaged over nodes (``_eval_phase``)

Messages carry node indices, not models: a message's payload is the
sender's row of the ring at its send round.

The state is updated in place: :meth:`GossipSimulator.start` mutates the
:class:`SimState` it is given and returns it.

Ported: ``fused_merge="multi"`` over the wide population, PUSH, sync
nodes, no delay, an fp32 ring. Every other option of the JAX engine raises
``NotImplementedError``.
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
from ..handlers.base import ModelState
from ..ops.merge import gather_merge_multi
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
    history_params: torch.Tensor   # [D, N, stride] round-start snapshots
    history_ages: torch.Tensor     # [D, N] int32 snapshot ages
    mailbox: Mailbox
    round: int = 0


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
    """Vanilla gossip simulator, fused single-pass deliver.

    Parameters follow ``gossipy_tpu.simulation.GossipSimulator``; those the
    port has not taken over raise ``NotImplementedError`` when set to
    anything but their default. Beyond them:

    draws : DrawProvider | None
        Source of every random draw of the run (default
        :class:`~gossipy_tpu_torch.random.TorchDraws` seeded with 42).
    device : str | torch.device | None
        ``cuda`` unless ``"cpu"`` is passed; raises without a card.
    """

    _SLOT_FLOOR = 6
    _SLOT_CAP = 64

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
                 compact_deliver: Optional[bool] = None,
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
        unported = {"mesh": mesh, "probes": probes, "sentinels": sentinels,
                    "chaos": chaos, "perf": perf, "metrics": metrics,
                    "cohort": cohort, "tracing": tracing, "ledger": ledger,
                    "compact_deliver": compact_deliver or None}
        for name, val in unported.items():
            if val is not None:
                raise NotImplementedError(f"{name}= is not ported yet")
        if history_dtype != "float32":
            raise NotImplementedError(
                f"history_dtype={history_dtype!r} is not ported yet (fp32 "
                "ring only)")
        if fused_merge is True:
            fused_merge = "multi"
        if fused_merge != "multi":
            raise NotImplementedError(
                f"fused_merge={fused_merge!r} is not ported yet: the port "
                "runs the single-pass fused deliver (fused_merge='multi')")
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
        # The fused kernel replaces the merge with a fixed two-way blend:
        # only a uniform-average MERGE_UPDATE handler that declares its
        # blend coefficient may take it.
        if not getattr(handler, "uniform_avg_merge", False):
            raise ValueError("fused_merge requires a uniform-average merge "
                             "handler")
        if getattr(handler, "merge_peer_weight", None) is None:
            raise ValueError("fused_merge requires the handler to declare "
                             "its blend coefficient (merge_peer_weight)")
        if handler.mode != CreateModelMode.MERGE_UPDATE:
            raise ValueError("fused_merge only fuses the MERGE_UPDATE path")

        self.device = resolve_device(device)
        self.handler = handler
        self.topology = topology
        self.n_nodes = topology.num_nodes
        self.delta = int(delta)
        self.drop_prob = float(drop_prob)
        self.online_prob = float(online_prob)
        self.delay = delay
        self.eval_every = int(eval_every)
        self.F = 1
        self.K = (self._derive_mailbox_slots(self._lam_max())
                  if mailbox_slots is None else int(mailbox_slots))
        self._warn_if_mailbox_undersized()
        self._message_size = message_size
        self.draws = draws if draws is not None else TorchDraws(42)
        self.data = to_device(data, self.device)
        self.has_local_test = "xte" in self.data
        self.has_global_eval = "x_eval" in self.data
        self._adj = topology.adjacency_on(self.device)
        self._metric_names: Optional[list] = None

    # -- mailbox sizing ----------------------------------------------------

    def _lam_max(self) -> float:
        """Worst-case expected same-round fan-in under uniform peer draws:
        ``max_i sum_{j -> i} F / deg_j``."""
        if self.n_nodes == 0:
            return 0.0
        deg = np.maximum(self.topology.degrees.astype(np.float64), 1.0)
        return float(((self.F / deg) @ self.topology.adjacency).max())

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
        ``model``'s params in every cell and the mailbox is empty."""
        n = self.n_nodes
        params = model.params.to(self.device, torch.float32).contiguous()
        n_updates = model.n_updates.to(self.device, torch.int32)
        D = self._history_depth(self._model_size())
        return SimState(
            model=ModelState(params, n_updates),
            phase=phase.to(self.device, torch.int32),
            history_params=params.unsqueeze(0).repeat(D, 1, 1),
            history_ages=n_updates.unsqueeze(0).repeat(D, 1),
            mailbox=Mailbox.empty(D, n, self.K, self.device),
        )

    # -- per-round phases --------------------------------------------------

    def _snapshot(self, state: SimState, r: int) -> None:
        b = r % state.history_ages.shape[0]
        state.history_params[b].copy_(state.model.params)
        state.history_ages[b].copy_(state.model.n_updates)

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

    def _fused_multi_tables(self, state: SimState, sr_t, sender_t, apply_t):
        """The ``[N, K]`` kernel tables of one mailbox cell: flat ring
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

    def _fused_multi_apply(self, state: SimState, sr_t, sender_t, apply_t,
                           perms, any_msg) -> None:
        """One kernel launch and one update over all N receivers: the
        compound left-to-right K-slot blend, age = max over the live
        peers, then the local update; rows without a live message keep
        their state."""
        flat_idx, w_self, w_peer, peer_ages = self._fused_multi_tables(
            state, sr_t, sender_t, apply_t)
        model = state.model
        ring = state.history_params.view(-1, state.history_params.shape[-1])
        merged = gather_merge_multi(model.params, ring, flat_idx, w_self,
                                    w_peer)
        live_ages = torch.where(apply_t, peer_ages,
                                torch.zeros_like(peer_ages)).amax(dim=1)
        ages = torch.maximum(model.n_updates, live_ages)
        updated = self.handler.update(ModelState(merged, ages),
                                      self._local_data(), perms)
        state.model = ModelState(
            torch.where(any_msg[:, None], updated.params, model.params),
            torch.where(any_msg, updated.n_updates, model.n_updates))

    def _deliver_phase(self, state: SimState, r: int):
        """Single-pass fused deliver of this round's mailbox cell; returns
        the failure counts and the diagnostics of the cell."""
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
        apply_t = occupied_t & online[:, None]
        carries = ((ty_t == MessageType.PUSH) | (ty_t == MessageType.PUSH_PULL)
                   | (ty_t == MessageType.REPLY))
        apply_t = apply_t & carries
        fails = FailureCounts(offline=(occupied_t & ~online[:, None]).sum())
        any_msg = apply_t.any(dim=1)
        occ_slots = apply_t.any(dim=0).sum()
        has_any = bool(any_msg.any())
        if has_any:
            # Each node trains under its first live slot's stream.
            first_k = torch.argmax(apply_t.to(torch.int32), dim=1)
            perms = self.draws.update_permutations(
                r, [K_CALL * 101 + k for k in range(self.K)], first_k,
                self.handler.local_epochs, self.data["mtr"].shape[1])
            self._fused_multi_apply(state, sr_t, sender_t, apply_t, perms,
                                    any_msg)
        box.clear_cell(b)
        wide = occ_slots if has_any else torch.zeros_like(occ_slots)
        return fails, {"mailbox_hwm": hwm, "wide_slots": wide}

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
            "compact_slots": 0,
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
