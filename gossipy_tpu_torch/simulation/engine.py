"""The gossip simulation engine: the gossip round.

Counterpart of ``gossipy_tpu/simulation/engine.py``. The JAX engine traces
a round into one XLA program; here a round is eager PyTorch on the run's
device, phase by phase:

    snapshot  the round-start params go into the ``[D, N, stride]``
              history ring, encoded in its wire format (``_snapshot``)
    send      every node that fires draws one peer; drop and delay draws;
              message metadata is scattered into the mailbox cell of its
              arrival round, ``(r + (offset + delay) // delta) % D``, of
              the ``[D, N, K]`` mailbox (``_send_phase``). Sync nodes fire
              once per round at their offset; async ones at every multiple
              of their period inside the round, up to
              ``max_fires_per_round`` sub-fires
    deliver   the cell's K slots are drained (``_deliver_phase``) by one of
              three paths, chosen by ``fused_merge``:
              - ``"multi"`` (the default where the handler admits it):
                ONE launch of the multi-slot
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
              an empty slot skips its whole pass. Under PULL and
              PUSH_PULL every request that reached an online node queues
              a REPLY, carrying the replier's snapshot, in the ``[D, N,
              Kr]`` reply box
    reply     the reply box's cell is drained by the same path
              (``_reply_phase``)
    eval      local and global metrics, averaged over the nodes, or over a
              random ``sampling_eval`` share of them (``_eval_phase``)

Messages carry node indices, not models: a message's payload is the
sender's row of the ring at its send round. The ring is stored in float32,
bfloat16 or int8 (``history_dtype``); an int8 ring keeps one float32 scale
per (ring cell, node, leaf) in ``history_scale``.

The state is updated in place: :meth:`GossipSimulator.start` mutates the
:class:`SimState` it is given and returns it.

Variants (``nodes.py``, ``variants.py``) hook into the round where the JAX
engine's do, each hook updating the state in place: ``_init_aux`` (the
variant's per-node state, ``state.aux``), ``_pre_send`` (before the
snapshot), ``_select_peers``, ``_send_gate`` and ``_send_extra`` (the send
phase), ``_reply_extra`` (the replies' payload), ``_decode_extra``,
``_receive_rows`` and ``_apply_receive`` (a slot's receive),
``_post_receive_slot`` (after each slot that held a message) and
``_post_deliver`` (after the deliver phase; its sends count in the
round's accounting). A fused path refuses a variant that overrides a
receive hook it replaces, as the JAX engine does
(:meth:`GossipSimulator._fused_refusal`).

Opt-in telemetry, as in the JAX engine (each None by default, and then
the round computes none of it):

- ``probes=`` (:mod:`~gossipy_tpu_torch.telemetry.probes`): consensus
  distance after the round; staleness and accepted merges folded slot by
  slot; the merge and train deltas, where the merged rows are the deliver
  kernel's own output (the fused paths keep the rows the gather-merge
  launch produced, before training) or, on the plain path, the handler's
  ``merge`` over the same gather;
- ``sentinels=`` (:mod:`~gossipy_tpu_torch.telemetry.health`): the
  round's vitals after :meth:`GossipSimulator._round`, against a copy of
  the round-start params, with a carry that persists across ``start()``
  calls until ``init_nodes``; the first slot whose delivery left a
  non-finite param;
- ``chaos=`` (:mod:`~gossipy_tpu_torch.simulation.faults`): forced-offline
  nodes neither send nor receive (the ``chaos`` failure cause), peers are
  drawn over the round's alive edges (on a dense topology one masked
  adjacency per distinct schedule mask, made once; on a sparse one a
  draw over the alive slots of the padded neighbour table, the JAX
  engine's ``"slot"`` form), drop and delay spikes.

Host-side observability, as in the JAX engine (each off by default;
none of it runs inside a round, draws or launches, so a run with all of
it on is bit-identical to the same run with it off):

- ``perf=`` (:mod:`~gossipy_tpu_torch.telemetry.cost`): one card
  synchronisation per ``start()``, the run's ms/round and MFU (the
  analytic per-round FLOPs over the measured round, against the card's
  bf16 peak) as ``perf_*`` report rows and ``update_perf`` events, the
  call's peak allocation banked, and :meth:`GossipSimulator.perf_summary`;
- ``metrics=`` (:mod:`~gossipy_tpu_torch.telemetry.metrics`): each
  finished ``start()`` feeds the process registry's engine counters, and
  the event stream's rows carry cumulative totals;
- ``ledger=`` (:mod:`~gossipy_tpu_torch.telemetry.ledger`): each finished
  ``start()`` appends its digest row, segments of one chunked run under
  one run id;
- ``start(profile_dir=...)``: the run under ``torch.profiler``, its
  Chrome trace exported into the directory. The round's phases are
  ``record_function`` ranges (:mod:`~gossipy_tpu_torch.telemetry.scopes`)
  whatever the options.

The topology is a dense :class:`~gossipy_tpu_torch.core.Topology` or a
:class:`~gossipy_tpu_torch.core.SparseTopology`. Over the second nothing
``[N, N]`` exists: peers are drawn into the CSR rows
(:meth:`~gossipy_tpu_torch.random.DrawProvider.csr_peers`) and the
expected fan-in that sizes the mailbox and the compaction is a scatter
over the edge list.

:class:`GossipSimulator` is a
:class:`~gossipy_tpu_torch.simulation.events.SimulationEventSender`:
receivers get the run's rounds replayed when it ends, or, when ``live``,
at each round boundary (one host sync a round, only then).

Ported: PUSH, PULL and PUSH_PULL, sync and async nodes, the three delay
models, sampled evaluation, the three deliver paths with wide and compact
dispatch, the three ring formats, every create-model mode (UPDATE_MERGE on
the plain path, as in the JAX engine), handlers with and without optimizer
state or shard orders (``BaseHandler``'s defaults), dense and sparse
topologies, probes, sentinels and chaos, event receivers, host span
tracing (``tracing=``; no ``engine.compile`` span, as nothing compiles),
``perf=``, ``metrics=``, ``ledger=`` and ``profile_dir=``,
:meth:`GossipSimulator.memory_budget` and its
:meth:`GossipSimulator.check_memory_budget`,
:meth:`GossipSimulator.run_manifest`, :meth:`GossipSimulator.save` and
:meth:`GossipSimulator.load` (:mod:`gossipy_tpu_torch.checkpoint`, the
draw state kept beside the state) and
:meth:`GossipSimulator.run_repetitions`, and active-cohort rounds
(``cohort=``, :mod:`~gossipy_tpu_torch.simulation.cohort`: a host pool of
nominal N, a ``[C]``-wide round a segment), and ``mesh=``
(:mod:`gossipy_tpu_torch.parallel`: the single-pass fused deliver as a
ring over the mesh's node axis, K1 on every hop; ``load(mesh=)``
restores into the mesh's placement).
"""

from __future__ import annotations

import dataclasses
import math
import os
import warnings
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from .. import resolve_device
from ..core import AntiEntropyProtocol, ConstantDelay, CreateModelMode, \
    Delay, MessageType, SparseTopology, Topology
from ..data import to_device
from ..handlers.base import ModelState, PeerModel, select_rows, \
    select_state
from ..ops import _build
from ..ops.merge import column_leaves, gather_merge_flat, gather_merge_multi
from ..random import K_CALL, K_DELAY, K_DROP, K_EXTRA, K_ONLINE, K_PEER, \
    K_REPLY_DELAY, K_REPLY_DROP, DrawProvider, TorchDraws
from ..telemetry import FailureCounts
from ..telemetry import scopes as _scopes
from ..telemetry.cost import PERF_STAT_KEYS, CostReport, PerfConfig, \
    analytic_round_cost, current_device_kind, mfu_estimate, peak_flops, \
    phase_times_from_trace
from ..telemetry.health import HEALTH_STAT_KEYS, HealthCarry, \
    SentinelConfig, health_event_row, health_round_stats, nonfinite_total
from ..telemetry.ledger import ingest_manifest, resolve_ledger
from ..telemetry.metrics import observe_engine_run
from ..telemetry.sink import emit_event
from ..telemetry.tracing import WAIT_CAT, attach_device_spans, \
    ensure_tracer, span
from ..telemetry.probes import PROBE_STAT_KEYS, ProbeAccum, ProbeConfig, \
    consensus_stats, param_layer_names, probe_event_row, \
    probe_stats_from_accum, sq_param_distance
from .cohort import COHORT_STAT_KEYS, CohortConfig, NominalTopology, \
    _CohortRoundTopology, setup_cohort
from .events import SimulationEventSender
from .faults import CHAOS_PROBE_KEYS, ChaosConfig, build_fault_schedule, \
    chaos_event_row, chaos_round_stats
from .report import SimulationReport

# Image rows one evaluation chunk may push through the model at once
# (nodes x eval samples): bounds the im2col buffers of the global eval.
EVAL_ROWS = 8192

_PROTO_TO_MSG = {AntiEntropyProtocol.PUSH: MessageType.PUSH,
                 AntiEntropyProtocol.PULL: MessageType.PULL,
                 AntiEntropyProtocol.PUSH_PULL: MessageType.PUSH_PULL}


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

    model: ModelState              # params [N, stride], opt_state (per-node
                                   # tensors), n_updates [N]
    phase: torch.Tensor            # [N] int32 send offset within a round
                                   # (sync) or send period (async)
    history_params: torch.Tensor   # [D, N, stride] round-start snapshots,
                                   # in the wire format
    history_ages: torch.Tensor     # [D, N, *age] int32 snapshot ages
                                   # (a partitioned handler's ages: [D, N, P])
    mailbox: Mailbox               # [D, N, K]
    reply_box: Mailbox             # [D, N, Kr]
    round: int = 0
    history_scale: Optional[torch.Tensor] = None  # [D, N, L] f32, int8 only
    aux: dict = dataclasses.field(default_factory=dict)  # a variant's
                                   # per-node state, leading node axis


def _take_rows(model: ModelState, idx: torch.Tensor) -> ModelState:
    return ModelState(model.params[idx],
                      tuple(t[idx] for t in model.opt_state),
                      model.n_updates[idx])


def _put_rows(model: ModelState, idx: torch.Tensor,
              part: ModelState) -> ModelState:
    """``model`` with rows ``idx`` replaced by ``part`` (a new state)."""
    return ModelState(model.params.index_copy(0, idx, part.params),
                      tuple(t.index_copy(0, idx, u) for t, u in
                            zip(model.opt_state, part.opt_state)),
                      model.n_updates.index_copy(0, idx, part.n_updates))


def fused_refusal(handler) -> Optional[str]:
    """Why the fused kernels may not replace ``handler``'s merge, or None
    when they may: they apply a fixed two-way blend, so only a
    uniform-average MERGE_UPDATE handler that declares its blend
    coefficient admits them."""
    if not getattr(handler, "uniform_avg_merge", False):
        return "fused_merge requires a uniform-average merge handler"
    if getattr(handler, "merge_peer_weight", None) is None:
        return ("fused_merge requires the handler to declare its blend "
                "coefficient (merge_peer_weight)")
    if handler.mode != CreateModelMode.MERGE_UPDATE:
        return "fused_merge only fuses the MERGE_UPDATE path"
    return None


def _take(perms: Optional[torch.Tensor], idx: torch.Tensor):
    """Rows ``idx`` of the shard orders (None stays None)."""
    return None if perms is None else perms[idx]


@dataclasses.dataclass
class _SlotTelemetry:
    """What a drain folds in for the probes and the sentinels: the probe
    accumulator (None when the slot probes are off) and the first slot
    whose delivery left a non-finite param (None when not tracked)."""

    pa: Optional[ProbeAccum] = None
    first_bad: Optional[torch.Tensor] = None


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


def _mean_metrics(res: dict, names: list, node_mask: torch.Tensor
                  ) -> torch.Tensor:
    vals = torch.stack([res[k] for k in names], dim=-1)
    w = node_mask.to(torch.float32)
    tot = w.sum()
    mean = (vals * w[:, None]).sum(0) / torch.clamp(tot, min=1.0)
    return torch.where(tot > 0, mean, torch.full_like(mean, float("nan")))


def metric_names(handler, data: dict, device) -> list:
    """The sorted names of the metrics ``handler.evaluate`` gives, from
    one freshly initialised row on one sample of ``data`` (its local test
    set, else its training set)."""
    key = "xte" if "xte" in data else "xtr"
    d = tuple(data[p + key[1:]][:1, :1] for p in "xym")
    params = handler.init(torch.Generator().manual_seed(0), device).params
    return sorted(handler.evaluate(ModelState(params[None], (), None), d))


@torch.no_grad()
def population_metrics(handler, params: torch.Tensor, data: dict,
                       names: list, idx: Optional[torch.Tensor] = None):
    """``(local, global)``: the mean metric vectors (``names`` order) of
    the rows ``params`` (of the rows ``idx`` only, when given) on their
    own test shards (``xte``, ``yte``, ``mte`` of ``data``, nodes with no
    test sample left out) and on the shared eval set (``x_eval``,
    ``y_eval``), pushed through the model in chunks of at most
    ``EVAL_ROWS`` rows; an all-NaN vector where ``data`` has no such set
    or no node a test sample."""
    dev = params.device
    nan = torch.full((len(names),), float("nan"), device=dev)
    if idx is not None:
        params = params[idx]
    m = params.shape[0]
    local = nan
    if "xte" in data:
        d = tuple(data[k] if idx is None else data[k][idx]
                  for k in ("xte", "yte", "mte"))
        res = handler.evaluate(ModelState(params, (), None), d)
        local = _mean_metrics(res, names, d[2].sum(dim=1) > 0)
    glob = nan
    if "x_eval" in data:
        xe, ye = data["x_eval"], data["y_eval"]
        me = torch.ones(xe.shape[0], device=dev)
        chunk = max(1, EVAL_ROWS // max(1, xe.shape[0]))
        parts = []
        for lo in range(0, m, chunk):
            p = params[lo:lo + chunk]
            c = p.shape[0]
            d = (xe.expand(c, *xe.shape), ye.expand(c, *ye.shape),
                 me.expand(c, *me.shape))
            parts.append(handler.evaluate(ModelState(p, (), None), d))
        res = {k: torch.cat([part[k] for part in parts]) for k in names}
        glob = _mean_metrics(res, names,
                             torch.ones(m, dtype=torch.bool, device=dev))
    return local, glob


class MemoryBudgetExceeded(RuntimeError):
    """The predicted device-memory footprint exceeds the card's budget.

    Raised by :meth:`GossipSimulator.check_memory_budget` before any
    launch, naming the predicted bytes, the limit and the dominant term;
    carries ``predicted_bytes``, ``limit_bytes``, ``dominant_term`` and
    the whole ``budget`` dict."""

    def __init__(self, predicted_bytes: int, limit_bytes: int,
                 dominant_term: str, budget: dict):
        self.predicted_bytes = int(predicted_bytes)
        self.limit_bytes = int(limit_bytes)
        self.dominant_term = dominant_term
        self.budget = budget
        super().__init__(
            f"memory budget refused: predicted "
            f"{predicted_bytes / 2**30:.2f} GB exceeds the "
            f"{limit_bytes / 2**30:.2f} GB limit; dominant term "
            f"{dominant_term} = {budget.get(dominant_term, 0) / 2**30:.2f} "
            "GB")


class GossipSimulator(SimulationEventSender):
    """Vanilla gossip simulator.

    Parameters follow ``gossipy_tpu.simulation.GossipSimulator``; those the
    port has not taken over raise ``NotImplementedError`` when set to
    anything but their default. Differences:

    fused_merge : None | False | "multi" | True | "per_slot"
        The deliver path (``True`` means ``"multi"``). The default
        (``None``) is ``"multi"`` when the handler and the simulator admit
        a fused deliver (:meth:`_fused_refusal` finds nothing), else the
        plain path, where the JAX engine's default is always ``False``.
        Naming a fused path that is refused raises ``ValueError``.
    compact_deliver : None | bool | int
        As in the JAX engine: ``None`` turns compaction on for the plain
        path at N >= 48 with K > 1; ``True`` derives the capacity; an int
        sets it. The ``"per_slot"`` path takes no compaction.
    reply_slots : int
        ``Kr``, the reply box's slots per node and round (PULL and
        PUSH_PULL).
    history_dtype : "float32" | "bfloat16" | "int8"
        The ring's wire format.
    probes, sentinels, chaos
        As in the JAX engine: ``ProbeConfig`` or bool, ``SentinelConfig``
        or bool, ``ChaosConfig`` or dict.
    tracing : None | bool | Tracer
        Host span tracing (:mod:`~gossipy_tpu_torch.telemetry.tracing`):
        ``True`` records into the process-default tracer, a ``Tracer``
        into itself; None does no tracing work.
    perf : None | bool | PerfConfig
        Performance observability (:mod:`~gossipy_tpu_torch.telemetry.
        cost`); :meth:`perf_summary` reads it.
    metrics : bool
        Feed the process metrics registry
        (:mod:`~gossipy_tpu_torch.telemetry.metrics`) after each run.
    ledger : None | False | str | RunLedger
        The run ledger (:mod:`~gossipy_tpu_torch.telemetry.ledger`):
        None consults ``GOSSIPY_TPU_LEDGER`` (unset: off), False is off, a
        path or a ``RunLedger`` is explicit.
    cohort : CohortConfig | int | dict | None
        Sampled active-cohort mode (:mod:`~gossipy_tpu_torch.simulation.
        cohort`): ``topology`` names the nominal population (a real
        topology, or a :class:`~gossipy_tpu_torch.simulation.cohort.
        NominalTopology` size in resample mode), the population lives in
        a host :class:`~gossipy_tpu_torch.simulation.cohort.CohortPool`
        (:meth:`init_cohort_pool`) and each round puts only C sampled
        nodes on the device.
    draws : DrawProvider | None
        Source of every random draw of the run (default
        :class:`~gossipy_tpu_torch.random.TorchDraws` seeded with 42).
    device : str | torch.device | None
        ``cuda`` unless ``"cpu"`` is passed; raises without a card.
    """

    _SLOT_FLOOR = 6
    _SLOT_CAP = 64
    # memory_budget's one-node terms (_one_node_terms), made once.
    _one_node: Optional[tuple] = None
    _HISTORY_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                       "int8": torch.int8}

    def __init__(self,
                 handler,
                 topology: Union[Topology, SparseTopology],
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
                 reply_slots: int = 2,
                 message_size: Optional[int] = None,
                 fused_merge: Union[None, bool, str] = None,
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
        # Sampled active-cohort mode (simulation.cohort): ``topology``
        # names the NOMINAL population (a real graph, or a
        # NominalTopology size) and is swapped here for the C-node round
        # world the rest of construction sizes against; the population
        # lives in a host-resident CohortPool (init_cohort_pool), and
        # start() drives gather -> [C]-round -> scatter segments.
        self.cohort = CohortConfig.coerce(cohort)
        self.nominal_topology = None
        self.nominal_n = int(topology.num_nodes)
        # The live disk-backed pool store (CohortConfig.pool_dir), owned
        # by init_cohort_pool/load; None otherwise.
        self._pool_store = None
        if self.cohort is not None:
            if chaos is not None:
                raise ValueError(
                    "cohort mode and chaos scheduling are mutually "
                    "exclusive (fault schedules are nominal-population-"
                    "indexed; the active cohort rotates)")
            topology = setup_cohort(self, topology)
        elif isinstance(topology, NominalTopology):
            raise ValueError("NominalTopology is a population size for "
                             "cohort= runs; a run without cohort= needs a "
                             "Topology or a SparseTopology")
        if fused_merge is None:
            fused_merge = ("multi" if self._fused_refusal(handler, "multi")
                           is None else False)
        if fused_merge is True:
            fused_merge = "multi"
        elif not fused_merge:
            fused_merge = False
        elif fused_merge not in ("multi", "per_slot"):
            raise ValueError(f"unknown fused_merge mode {fused_merge!r}; "
                             "options: False, True/'multi', 'per_slot'")
        if not isinstance(topology, (Topology, SparseTopology,
                                     _CohortRoundTopology)):
            raise TypeError("topology must be a Topology or a SparseTopology,"
                            f" got {type(topology).__name__}")
        if max_fires_per_round is None:
            max_fires_per_round = 1 if sync else 2
        if max_fires_per_round < 1 or reply_slots < 1:
            raise ValueError("need max_fires_per_round >= 1 and "
                             "reply_slots >= 1")
        if eval_every < 1:
            raise ValueError("eval_every must be >= 1")
        refusal = fused_merge and self._fused_refusal(handler, fused_merge)
        if refusal:
            raise ValueError(refusal)
        if mesh is not None and fused_merge != "multi":
            raise ValueError("GossipSimulator(mesh=) shards the single-pass "
                             "fused deliver; pass fused_merge=True/'multi'")

        self.device = resolve_device(device)
        self.handler = handler
        self.topology = topology
        self._sparse = isinstance(topology, SparseTopology)
        self.n_nodes = topology.num_nodes
        self.delta = int(delta)
        self.protocol = AntiEntropyProtocol(protocol)
        self.drop_prob = float(drop_prob)
        self.online_prob = float(online_prob)
        self.delay = delay
        self.sampling_eval = float(sampling_eval)
        self.eval_every = int(eval_every)
        self.sync = bool(sync)
        self.fused_merge = fused_merge
        self.history_dtype = history_dtype
        self.F = int(max_fires_per_round)
        self._lam_vec: Optional[np.ndarray] = None
        self.K = (self._derive_mailbox_slots(self._lam_max())
                  if mailbox_slots is None else int(mailbox_slots))
        self.Kr = int(reply_slots)
        self._warn_if_mailbox_undersized()
        self._compact_cap = self._compact_capacity(compact_deliver)
        self._init_mesh(mesh)
        self._message_size = message_size
        self.draws = draws if draws is not None else TorchDraws(42)
        self.data = to_device(data, self.device)
        self.has_local_test = "xte" in self.data
        self.has_global_eval = "x_eval" in self.data
        # The topology on the device, in its own form: the dense bool
        # adjacency, or the CSR neighbour lists (and no [N, N] at all).
        self._adj = (None if self._sparse or self.cohort is not None
                     else topology.adjacency_on(self.device))
        self._csr = topology.csr_on(self.device) if self._sparse else None
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
        self._slot_hook = (type(self)._post_receive_slot
                           is not GossipSimulator._post_receive_slot)
        self.probes = ProbeConfig.coerce(probes)
        self.sentinels = SentinelConfig.coerce(sentinels)
        # The sentinels' cross-round state: persists across start() calls,
        # reset by init_nodes.
        self._health_carry: Optional[HealthCarry] = None
        # The merge/train-delta decomposition is exact only for the base
        # receive pipeline under MERGE_UPDATE; elsewhere it is NaN.
        self._probe_delta_ok = (
            self.probes is not None and self.probes.mixing
            and handler.mode == CreateModelMode.MERGE_UPDATE
            and not self._overridden(["_apply_receive", "_receive_rows"]))
        self._init_chaos(ChaosConfig.coerce(chaos))
        # Host-side span tracing (telemetry.tracing): None (no tracing
        # work at all), True (the process-default tracer) or a Tracer.
        if tracing is None or tracing is False:
            self.tracer = None
        elif tracing is True:
            self.tracer = ensure_tracer()
        else:
            self.tracer = tracing
        # Performance observability (telemetry.cost), the metrics feed
        # (telemetry.metrics) and the run ledger (telemetry.ledger): host
        # side, after a run; the rounds are the same with them on or off.
        self.perf: Optional[PerfConfig] = PerfConfig.coerce(perf)
        self._cost_reports: list = []
        self._perf_last: Optional[dict] = None
        self._analytic: Optional[dict] = None
        self.metrics_enabled: bool = bool(metrics)
        self._metrics_base = {"rounds": 0, "sent": 0, "failed": 0}
        self.ledger = resolve_ledger(ledger)
        self._ledger_run_id: Optional[str] = None
        if self.perf is not None:
            # The MFU numerator, counted once here (set-up), so that no
            # start() pays for it.
            self._analytic_cost()

    def _init_mesh(self, mesh) -> None:
        """The mesh-sharded fused deliver (JAX engine.py:624-639, :681-684):
        the multi-slot merge runs as a ring over the mesh's node axis
        (:func:`~gossipy_tpu_torch.parallel.collectives.
        sharded_gather_merge_multi`), one K1 launch a position a hop. The
        node count must divide the ring, the compacted pass (a row subset
        the ring cannot re-shard) is refused, and the mesh's positions must
        all name this simulator's device (a state across cards is not
        ported)."""
        self.mesh = mesh
        if mesh is None:
            return
        from ..parallel import _ACROSS_CARDS, _node_axis_entry, \
            canonical_device
        from ..parallel.collectives import _axis_size
        self._fused_ring_axis = _node_axis_entry(mesh, None)
        if self.n_nodes % _axis_size(mesh, self._fused_ring_axis):
            raise ValueError("node count must divide the mesh's node axes "
                             "for the sharded fused deliver")
        if self._compact_cap is not None:
            raise ValueError("compact_deliver gathers a [cap] row subset, "
                             "which the mesh-sharded fused deliver cannot "
                             "re-shard; use one or the other")
        if not mesh.is_virtual() or mesh.device() != canonical_device(
                self.device):
            raise NotImplementedError(_ACROSS_CARDS)

    def _init_chaos(self, chaos: Optional[ChaosConfig]) -> None:
        """Compile the chaos config into its tables: on the host (the
        per-round rates and mask indices, read by round number) and on
        the device (forced-offline rows, component ids)."""
        self.chaos = chaos
        self.chaos_schedule = None
        self._chaos_edges = False
        if chaos is None:
            return
        self._chaos_edges = chaos.has_edge_faults()
        if self._chaos_edges and self._overridden(["_select_peers"]) \
                and not self._overridden(["_round"]):
            raise ValueError(
                f"{type(self).__name__} overrides _select_peers; chaos "
                "partitions/churn mask the BASE uniform peer sampling and "
                "would be silently bypassed — use outage/spike faults only, "
                "or drop chaos")
        sched = build_fault_schedule(chaos, self.topology, self.drop_prob)
        self.chaos_schedule = sched
        self._chaos_forced = torch.as_tensor(sched.forced_offline,
                                             device=self.device)
        self._chaos_comp = torch.as_tensor(sched.component_id,
                                           device=self.device)
        self._chaos_ncomp = chaos.max_components()
        if not self._chaos_edges:
            return
        if self._sparse:
            # The JAX engine's "slot" form: the padded neighbour table and
            # the schedule's per-slot alive masks, each mask ANDed with the
            # table's used slots once.
            from .nodes import build_neighbor_table
            self._chaos_nbr = torch.as_tensor(
                build_neighbor_table(self.topology), device=self.device)
            used = self._chaos_nbr >= 0
            self._chaos_alive = torch.as_tensor(
                sched.slot_masks, device=self.device) & used
        else:
            self._chaos_adjs = {0: self._adj}

    # -- admission -----------------------------------------------------------

    # A subclass whose _decode_extra and _receive_rows overrides are
    # row-aligned (elementwise in the payload, per-node state read by node
    # id, per-row draws) declares it here to keep automatic compaction.
    _compact_safe = False

    def _overridden(self, hooks) -> list:
        return [h for h in hooks
                if getattr(type(self), h) is not getattr(GossipSimulator, h)]

    def _fused_refusal(self, handler, mode: str) -> Optional[str]:
        """Why fused path ``mode`` may not run this simulator, or None.
        The fused kernels replace the gather, decode and receive of a
        slot, so a variant overriding one of those hooks is refused; the
        single pass also collapses the slot loop, so it refuses per-slot
        hooks and reply payloads too (the JAX engine's rules,
        engine.py:598-617); then the handler's own rule
        (:func:`fused_refusal`)."""
        hooks = ["_apply_receive", "_receive_rows", "_gather_peer",
                 "_decode_extra"]
        if mode == "multi":
            hooks += ["_post_receive_slot", "_reply_extra"]
        over = self._overridden(hooks)
        if over:
            return (f"fused_merge requires the base receive path ({over[0]} "
                    f"is overridden by {type(self).__name__})")
        return fused_refusal(handler)

    # -- mailbox sizing and compaction ------------------------------------

    def _lam_vector(self) -> np.ndarray:
        """Per-node expected same-round fan-in under uniform peer draws:
        ``lam_i = sum_{j -> i} F / deg_j`` (computed once): a column sum of
        the dense adjacency, or each CSR row's ``F / deg`` scattered into
        its neighbours (``np.add.at``, O(E)). A cohort round draws over
        the active cohort (or its induced subgraph, whose fan-in the same
        draw bounds): exactly F per node, no nominal-topology scan."""
        if self._lam_vec is None and self.cohort is not None:
            self._lam_vec = np.full(self.n_nodes, float(self.F))
        if self._lam_vec is None:
            deg = np.maximum(self.topology.degrees.astype(np.float64), 1.0)
            inv = self.F / deg
            if self._sparse:
                lam = np.zeros(self.n_nodes)
                degrees = np.asarray(self.topology.degrees)
                if degrees.sum():
                    np.add.at(lam, self.topology.indices,
                              np.repeat(inv, degrees))
                self._lam_vec = lam
            else:
                self._lam_vec = np.asarray(inv @ self.topology.adjacency,
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
            emit_event("mailbox_undersized", {
                "mailbox_slots": self.K,
                "lam_max": lam_max,
                "p_overflow_per_node_round": p_over,
                "n_nodes": self.n_nodes,
                "simulator": type(self).__name__,
            })
            warnings.warn(
                f"mailbox_slots={self.K} may overflow on this topology: "
                f"worst-case expected same-round fan-in {lam_max:.1f} gives "
                f"~{p_over:.1%} per-node-round message loss (counted as "
                "'failed'). Raise mailbox_slots to silence.")

    def _compact_capacity(self, compact_deliver) -> Optional[int]:
        """The compacted pass's static receiver capacity, or None when
        compaction is off (the rules of engine.py:640-709): a variant
        keeps it only with the base ``_apply_receive`` and ``_gather_peer``
        and either the base ``_decode_extra`` and ``_receive_rows`` or a
        ``_compact_safe`` declaration."""
        base_receive = not self._overridden(["_apply_receive",
                                             "_gather_peer"])
        extra_ok = (not self._overridden(["_decode_extra", "_receive_rows"])
                    or type(self)._compact_safe)
        if compact_deliver is None:
            compact_deliver = (base_receive and extra_ok
                               and not self.fused_merge
                               and self.n_nodes >= 48 and self.K > 1)
        elif compact_deliver and not base_receive:
            raise ValueError("compact_deliver requires the base "
                             "_apply_receive/_gather_peer (overridden by "
                             f"{type(self).__name__}); pass "
                             "compact_deliver=False or None")
        elif compact_deliver and not extra_ok:
            raise ValueError(f"{type(self).__name__} overrides _decode_extra/"
                             "_receive_rows without declaring _compact_safe "
                             "= True; pass compact_deliver=False")
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
        """Bytes one model-carrying message (PUSH, PUSH_PULL or REPLY)
        moves under the wire format: the payload plus, for int8, one
        float32 scale per leaf (the scalars the JAX package counts; the
        port's row padding is not sent). A PULL request carries no model:
        the report counts it as one scalar."""
        layout = self.handler.layout
        sidecar = 4 * len(layout.leaves) if self.history_dtype == "int8" \
            else 0
        return layout.width * self._wire_itemsize() + sidecar

    # -- memory budget -------------------------------------------------------

    def _eval_peak_bytes(self) -> int:
        """Transient peak of the global evaluation's scores and metric
        operands: the JAX engine's ~3 float32 ``[eval nodes, eval
        samples]`` buffers, over the nodes of one of the port's chunks
        (``EVAL_ROWS`` image rows)."""
        if not self.has_global_eval:
            return 0
        n_samples = int(self.data["x_eval"].shape[0])
        chunk = max(1, EVAL_ROWS // max(1, n_samples))
        return 3 * min(self._n_eval_nodes(), chunk) * n_samples * 4

    def memory_budget(self) -> dict:
        """Device-memory budget (bytes) of the run's big terms, from shapes
        alone, with the JAX engine's keys and meaning:

        - ``model_and_opt_bytes``: params, optimizer state and ages of the
          N nodes;
        - ``history_ring_bytes``: the ``[D, N, stride]`` ring in its wire
          format, the int8 scales included; those are also given alone as
          ``history_ring_sidecar`` (no ``_bytes`` suffix, so the total
          counts them once); ``history_dtype`` names the format;
        - ``history_ages_bytes`` and ``history_depth`` (D);
        - ``aux_bytes``: a variant's own per-node state (``state.aux``);
        - ``mailbox_bytes``, ``reply_box_bytes``: four int32 fields of
          ``[D, N, K]`` and ``[D, N, Kr]``;
        - ``data_bytes``: the stacked data on the device;
        - ``eval_peak_bytes``: the global evaluation's transient
          (:meth:`_eval_peak_bytes`);
        - ``total_bytes``: the sum of the ``_bytes`` terms;
        - with ``cohort=``, those terms price the ``[C]``-wide round, and
          ``cohort_size``, ``nominal_n``, ``cohort_pool_resident`` (the
          host pool's bytes), ``cohort_active_total``,
          ``cohort_materialized_prediction`` (the N-scaled terms
          materialized) and ``cohort_pool_disk_backed`` are added.

        The port's rows are ``stride`` wide (the layout pads each row to a
        multiple of 4 floats), so its params, optimizer and ring terms
        count ``stride`` scalars a node where the JAX engine counts the
        model's width. Activations and the allocator's workspace are not
        counted: the budget is a floor, not a ceiling.
        """
        n = self.n_nodes
        layout = self.handler.layout
        age_shape, opt_bytes, aux_bytes = self._one_node_terms()
        ages = 4 * math.prod(age_shape)
        per_node = 4 * layout.stride + ages + opt_bytes
        D = self._history_depth(self._model_size())
        sidecar = (4 * D * n * len(layout.leaves)
                   if self.history_dtype == "int8" else 0)
        out = {
            "model_and_opt_bytes": per_node * n,
            "history_ring_bytes": (D * n * layout.stride
                                   * self._wire_itemsize() + sidecar),
            "history_ring_sidecar": sidecar,
            "history_dtype": self.history_dtype,
            "history_ages_bytes": ages * D * n,
            "history_depth": D,
            "aux_bytes": aux_bytes,
            "mailbox_bytes": 4 * 4 * D * n * self.K,
            "reply_box_bytes": 4 * 4 * D * n * self.Kr,
            "data_bytes": sum(t.numel() * t.element_size()
                              for t in self.data.values()),
            "eval_peak_bytes": self._eval_peak_bytes(),
        }
        out["total_bytes"] = sum(v for k, v in out.items()
                                 if k.endswith("_bytes"))
        if self.cohort is not None:
            # The keys above price the ACTIVE [C]-wide round (n == C);
            # the pool prices the nominal population's durable state on
            # the host, named without ``_bytes`` so the device total stays
            # the active round's. ``materialized_prediction``: the
            # N-scaled terms as a materialized run would hold them.
            from .cohort import pool_bytes
            n_scaled = sum(out[k] for k in (
                "model_and_opt_bytes", "history_ring_bytes",
                "history_ages_bytes", "aux_bytes", "mailbox_bytes",
                "reply_box_bytes"))
            out["cohort_size"] = self.n_nodes
            out["nominal_n"] = self.nominal_n
            out["cohort_pool_resident"] = pool_bytes(self)
            out["cohort_active_total"] = out["total_bytes"]
            out["cohort_materialized_prediction"] = (
                int(n_scaled * (self.nominal_n / max(self.n_nodes, 1)))
                + out["data_bytes"] + out["eval_peak_bytes"])
            out["cohort_pool_disk_backed"] = bool(self.cohort.pool_dir)
        return out

    def check_memory_budget(self, limit_bytes: Optional[int] = None
                            ) -> dict:
        """Predict and refuse: raise :class:`MemoryBudgetExceeded` when
        :meth:`memory_budget`'s total will not fit, before any launch.
        Returns the budget when it fits (or when no limit is known).

        The limit, first hit wins: ``limit_bytes``; the
        ``GOSSIPY_TPU_MEMORY_LIMIT`` variable (bytes); on the card, its
        total memory (``torch.cuda.mem_get_info()[1]``). A CPU run has no
        limit and passes, as on the JAX package's CPU backend. The budget
        is a floor (no activations, no allocator workspace), so what is
        refused here was certain to fail later."""
        budget = self.memory_budget()
        limit = limit_bytes
        if limit is None:
            env = os.environ.get("GOSSIPY_TPU_MEMORY_LIMIT")
            if env:
                limit = int(float(env))
        if limit is None and self.device.type == "cuda":
            limit = torch.cuda.mem_get_info(self.device)[1]
        if limit is None:
            return budget
        predicted = int(budget["total_bytes"])
        if predicted > int(limit):
            terms = {k: v for k, v in budget.items()
                     if k.endswith("_bytes") and k != "total_bytes"
                     and v is not None}
            dominant = max(terms, key=terms.get) if terms else "total_bytes"
            raise MemoryBudgetExceeded(predicted, int(limit), dominant,
                                       budget)
        return budget

    def run_manifest(self, extra: Optional[dict] = None):
        """The run's :class:`~gossipy_tpu_torch.telemetry.manifest.
        RunManifest`: config snapshot, backend and versions, git
        revision, :meth:`memory_budget`, (with ``tracing=``) the trace's
        totals and (with ``perf=``) :meth:`perf_summary`. Host side only,
        before or after a run."""
        from ..telemetry.manifest import RunManifest
        return RunManifest.from_simulator(self, extra=extra)

    # -- persistence ---------------------------------------------------------

    def save(self, path: str, state: SimState, draws=None) -> str:
        """Checkpoint ``state`` and the draw state of ``draws`` (default:
        the simulator's own provider) to the file ``path``
        (:func:`gossipy_tpu_torch.checkpoint.save_checkpoint`). A
        disk-backed cohort pool is checkpointed as hole-preserving copies
        of its files into the directory ``path``
        (:func:`~gossipy_tpu_torch.simulation.cohort.save_pool_store`)."""
        draws = self.draws if draws is None else draws
        if self.cohort is not None:
            from .cohort import is_mmap_pool, save_pool_store
            if is_mmap_pool(state):
                return save_pool_store(self, state, path, draws)
        from ..checkpoint import save_checkpoint
        return save_checkpoint(path, state, draws=draws)

    def load(self, path: str, mesh=None):
        """Restore ``(state, draws)`` saved by :meth:`save`, on a simulator
        built with the same configuration: the template is
        ``init_nodes(local_train=False)`` (which, as in the JAX engine,
        also resets the sentinels' carry), and the saved draw state goes
        into the simulator's own provider, returned as ``draws`` (None
        when the checkpoint kept none). ``mesh`` restores into the
        mesh's placement (:func:`~gossipy_tpu_torch.parallel.shard_state`
        of the template: on a virtual mesh the leaves stay whole on its
        device, their placement recorded).

        In cohort mode the unit is the resident
        :class:`~gossipy_tpu_torch.simulation.cohort.CohortPool`, and the
        template a zero-filled pool (no init at restore); a pool-store
        directory is copied into a work directory and opened there."""
        from ..checkpoint import restore_checkpoint
        if self.cohort is not None:
            from .cohort import is_pool_store_dir, load_pool_checkpoint, \
                pool_template
            if is_pool_store_dir(path):
                return load_pool_checkpoint(self, path)
            return restore_checkpoint(path, pool_template(self), self.draws)
        template = self.init_nodes(local_train=False)
        if mesh is not None:
            from ..parallel import shard_state
            template = shard_state(template, mesh)
        return restore_checkpoint(path, template, self.draws, mesh=mesh)

    def _one_node_terms(self) -> tuple:
        """``(age shape, optimizer bytes of one node, aux bytes)``, from a
        host model of one node and meta tensors, made once per simulator.
        ``memory_budget`` reads them, and the run ledger's manifest reads
        ``memory_budget`` after every ``start()``: they are made with the
        state (:meth:`init_state`, after a variant's own construction),
        so that a ledgered ``start()`` runs no op of its own."""
        if self._one_node is None:
            one = self.handler.init_opt_state(
                torch.zeros(1, self.handler.layout.stride))
            age_shape = self._age_shape()
            self._one_node = (age_shape,
                              sum(t.numel() * t.element_size() for t in one),
                              self._aux_bytes(age_shape))
        return self._one_node

    def _age_shape(self) -> tuple:
        """The shape of one node's age (``()``, or ``(P,)`` for a
        partitioned handler)."""
        one = self.handler.init(torch.Generator().manual_seed(0), "cpu")
        return tuple(one.n_updates.shape)

    def _aux_bytes(self, age_shape: tuple) -> int:
        """Bytes of ``state.aux``, from :meth:`_init_aux` over a model of
        meta tensors (shapes only, nothing allocated)."""
        n = self.n_nodes
        model = ModelState(
            torch.empty(n, self.handler.layout.stride, device="meta"), (),
            torch.empty((n,) + age_shape, dtype=torch.int32, device="meta"))
        return sum(t.numel() * t.element_size()
                   for t in self._init_aux(model).values())

    # -- state -------------------------------------------------------------

    def _local_data(self):
        return (self.data["xtr"], self.data["ytr"], self.data["mtr"])

    def _model_size(self) -> int:
        if self._message_size is not None:
            return self._message_size
        return int(self.handler.get_size())

    def _history_depth(self, size: int) -> int:
        """Ring depth covering the worst in-flight delay: the send offset
        (at most ``delta - 1``), the delay (times the worst scheduled
        chaos delay spike), and one reply's delay (2 at delay 0)."""
        max_d = self.delay.max_delay(size)
        if self.chaos is not None:
            max_d = int(math.ceil(max_d * self.chaos.max_delay_scale()))
        return max(2, (self.delta - 1 + 2 * max_d) // self.delta + 2)

    def init_nodes(self, generator: Optional[torch.Generator] = None,
                   local_train: bool = True,
                   common_init: bool = False) -> SimState:
        """Initialise every node's model (weights and age from the
        handler's ``init`` under ``generator``, default seeded with 0) and
        optimizer state, then one local pre-training pass.

        ``common_init=True`` gives every node the same initial weights; the
        pre-training pass still diversifies them.
        """
        if self.cohort is not None:
            raise ValueError(
                "cohort mode keeps the population in a resident pool — "
                "use init_cohort_pool() and start(pool, ...) instead of "
                "init_nodes()")
        n = self.n_nodes
        self._health_carry = None   # a fresh population, a fresh EMA
        g = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        if common_init:
            one = self.handler.init(g, self.device)
            params = one.params.unsqueeze(0).repeat(n, 1)
            n_updates = one.n_updates.unsqueeze(0).repeat(
                n, *[1] * one.n_updates.dim())
        else:
            # One init a node, made on the host and copied in one piece:
            # at population scale a copy per node would dominate.
            inits = [self.handler.init(g, "cpu") for _ in range(n)]
            params = torch.stack([m.params for m in inits]).to(self.device)
            n_updates = torch.stack([m.n_updates for m in inits]).to(
                self.device)
        model = ModelState(params, self.handler.init_opt_state(params),
                           n_updates.to(torch.int32))
        if local_train:
            epochs = self.handler.orders_per_update()
            perms = None if epochs is None else self.draws.init_permutations(
                n, epochs, self.data["mtr"].shape[1], self.device)
            model = self.handler.update(model, self._local_data(), perms)
        if self.sync:
            phase = self.draws.init_phase(n, self.delta, self.device)
        else:
            phase = self.draws.init_period(n, self.delta, self.device)
        return self.init_state(model, phase)

    def init_cohort_pool(self, generator: Optional[torch.Generator] = None,
                         common_init: bool = False,
                         local_train: bool = False,
                         block: Optional[int] = None):
        """Cohort-mode population init: the resident
        :class:`~gossipy_tpu_torch.simulation.cohort.CohortPool` of
        nominal size N on the host, built in blocks
        (:func:`gossipy_tpu_torch.simulation.cohort.init_cohort_pool`)."""
        if self.cohort is None:
            raise ValueError("init_cohort_pool requires cohort=; use "
                             "init_nodes() for materialized populations")
        from .cohort import init_cohort_pool
        return init_cohort_pool(self, generator, common_init=common_init,
                                local_train=local_train, block=block)

    def init_state(self, model: ModelState, phase: torch.Tensor) -> SimState:
        """A round-0 state around given node models (their optimizer
        state included): the ring holds ``model``'s params, encoded, in
        every cell, the mailbox and reply box are empty, and ``aux`` is
        the variant's initial state (:meth:`_init_aux`)."""
        n = self.n_nodes
        # The memory budget's one-node terms, made once here (set-up), so
        # that no start() runs ops for them (the ledger's manifest reads
        # the budget after every start()).
        self._one_node_terms()
        params = model.params.to(self.device, torch.float32).contiguous()
        opt_state = tuple(t.to(self.device) for t in model.opt_state)
        n_updates = model.n_updates.to(self.device, torch.int32)
        D = self._history_depth(self._model_size())
        stored, scales = self._encode_history_rows(params)
        model = ModelState(params, opt_state, n_updates)
        return SimState(
            model=model,
            phase=phase.to(self.device, torch.int32),
            history_params=stored.unsqueeze(0).repeat(D, 1, 1),
            history_ages=n_updates.unsqueeze(0).repeat(
                D, *[1] * n_updates.dim()),
            mailbox=Mailbox.empty(D, n, self.K, self.device),
            reply_box=Mailbox.empty(D, n, self.Kr, self.device),
            history_scale=(None if scales is None
                           else scales.unsqueeze(0).repeat(D, 1, 1)),
            aux=self._init_aux(model),
        )

    # -- variant hooks (the JAX engine's, engine.py:1324-1409, 2269-2289) -----

    def _init_aux(self, model: ModelState) -> dict:
        """A variant's per-node state (token balances, caches...), built
        on ``model.params``' device: none here."""
        return {}

    def _pre_send(self, state: SimState, r: int) -> None:
        """Before the round's snapshot (the neighbour cache merges a
        parked model here, so that the snapshot carries it)."""

    def _select_peers(self, state: SimState, r: int, f: int) -> torch.Tensor:
        """Sub-fire ``f``'s peer of every node (``-1``: none), over the
        round's alive edges under chaos partitions or churn. A cohort
        round draws over the cohort, or in induced mode over the
        cohort-local neighbour table riding ``state.aux["cohort_nbr"]``
        (a node with no neighbour in the cohort gets -1)."""
        if self.cohort is not None:
            if self.cohort.peer_mode == "induced":
                nbr = state.aux["cohort_nbr"]
                return self.draws.slot_peers(r, nbr, nbr >= 0, sub=f)
            return self.draws.cohort_peers(r, self.n_nodes, self.device,
                                           sub=f)
        return self._chaos_masked_peers(r, sub=f)

    def _send_gate(self, state: SimState, active: torch.Tensor,
                   peers: torch.Tensor, r: int, f: int) -> torch.Tensor:
        """Which of the ``active`` senders send (token accounts, PENS's
        selection counts); may update ``state.aux``."""
        return active

    def _send_extra(self, state: SimState, r: int, purpose: int,
                    sub: int = 0) -> torch.Tensor:
        """The ``[N]`` int32 payload of every sender's message (partition
        ids, sample seeds, degrees...), drawn under ``purpose``."""
        return torch.zeros(self.n_nodes, dtype=torch.int32,
                           device=self.device)

    def _reply_extra(self, state: SimState, r: int,
                     purpose: int) -> torch.Tensor:
        """The ``[N]`` int32 payload of every replier's REPLY."""
        return torch.zeros(self.n_nodes, dtype=torch.int32,
                           device=self.device)

    def _decode_extra(self, extra: torch.Tensor):
        """The handler's ``extra`` argument from a slot's payloads
        (row-aligned); the base protocol carries nothing."""
        return None

    def _post_receive_slot(self, state: SimState, valid, ty, sender,
                           send_round, extra, r: int, k: int) -> None:
        """After mailbox slot ``k`` was delivered (token reactions).
        Called for each slot that held a live message; the JAX engine
        calls it for every slot, and on one without any its hooks
        change nothing."""

    def _post_deliver(self, state: SimState, r: int):
        """After the deliver phase, the cell cleared; may send more.
        Returns ``(n_sent, fails, size)``."""
        return 0, FailureCounts(), 0

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

    def _fire_mask(self, state: SimState, r: int, f: int):
        """``(fires [N] bool, offset [N])`` of sub-fire ``f``: sync nodes
        fire once, at their offset; an async node fires at every multiple
        of its period inside the round's window ``[r delta, (r + 1)
        delta)``, at that time's offset within the round (every async node
        fires at time 0, as in the original gossipy)."""
        if self.sync:
            return (torch.ones(self.n_nodes, dtype=torch.bool,
                               device=self.device), state.phase.long())
        period = state.phase.long()
        lo = r * self.delta
        first = (lo + period - 1) // period * period
        t_f = first + f * period
        return t_f < lo + self.delta, (t_f - lo).clamp(0, self.delta - 1)

    def _send_phase(self, state: SimState, r: int):
        """Every sub-fire's sends, all carrying the round-start snapshot;
        sub-fire ``f`` draws under ``sub=f``. A PULL request counts as one
        scalar."""
        n = self.n_nodes
        dev = self.device
        size = (1 if self.protocol == AntiEntropyProtocol.PULL
                else self._model_size())
        msg_type = int(_PROTO_TO_MSG[self.protocol])
        senders = torch.arange(n, device=dev)
        n_sent, fails = 0, FailureCounts()
        # A sync node fires once: sub-fires past the first send nothing.
        for f in range(1 if self.sync else self.F):
            fires, offset = self._fire_mask(state, r, f)
            if self.chaos is not None:
                # A forced-offline node neither sends nor receives.
                fires = fires & ~self._chaos_forced_offline(r)
            peers = self._select_peers(state, r, f)
            active = self._send_gate(state, fires & (peers >= 0), peers, r,
                                     f)
            dropped = self.draws.bernoulli(r, K_DROP,
                                           self._chaos_drop_prob(r), n, dev,
                                           sub=f)
            delays = self._chaos_scale_delays(
                self.delay.sample(self.draws, r, K_DELAY, n, size, dev,
                                  sub=f), r)
            dr = (offset + delays) // self.delta
            n_sent = n_sent + active.sum()
            live = active & ~dropped
            n_overflow = self._scatter_messages(
                state.mailbox, live, dr, peers, senders, r, msg_type,
                self._send_extra(state, r, K_EXTRA, f), r, self.K)
            fails = fails + FailureCounts(drop=(active & dropped).sum(),
                                          overflow=n_overflow)
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

    def _update_orders(self, r: int, purposes, first_k: torch.Tensor,
                       split: bool = False) -> Optional[torch.Tensor]:
        """The shard orders of a round's local update
        (:meth:`DrawProvider.update_permutations`), or None for a handler
        whose update draws nothing."""
        epochs = self.handler.orders_per_update()
        if epochs is None:
            return None
        return self.draws.update_permutations(
            r, purposes, first_k, epochs, self.data["mtr"].shape[1],
            split=split)

    def _delivery_path_counts(self, n_live: int) -> tuple[int, int]:
        """(compact, wide) 0/1 indicators of one slot's pass, from the
        slot's live receiver count, as :meth:`_receive_slot_apply`
        dispatches it."""
        if n_live == 0:
            return 0, 0
        if self._compact_cap is not None and n_live <= self._compact_cap:
            return 1, 0
        return 0, 1

    def _slot_loop(self, state: SimState, r: int, sr_t, sender_t, apply_t,
                   extra_t, call_tag: int, post=None,
                   tel: Optional[_SlotTelemetry] = None) -> tuple[int, int]:
        """One pass per occupied slot of a mailbox cell, in slot order;
        slot ``k`` trains every node under purpose ``call_tag * 101 + k``
        (both halves of it under UPDATE_MERGE). ``post = (valid_t,
        ty_t)`` calls :meth:`_post_receive_slot` after each slot that
        held a live message (the deliver phase's cell; the reply phase
        passes None). ``tel`` folds each slot into the probes and the
        first-bad-slot sentinel. Returns the (compact, wide) slot
        counts."""
        n = self.n_nodes
        counts = [apply_t.sum(dim=0)]
        hooked = post is not None and self._slot_hook
        if hooked:
            counts.append(post[0].any(dim=0))
        counts = torch.stack([c.long() for c in counts]).tolist()
        live = counts[0]
        first_k = torch.zeros(n, dtype=torch.int64, device=self.device)
        # UPDATE_MERGE trains two models a receive: two sets of orders.
        split = self.handler.mode == CreateModelMode.UPDATE_MERGE
        n_compact = n_wide = 0
        for k, n_live in enumerate(live):
            dc, dw = self._delivery_path_counts(n_live)
            n_compact += dc
            n_wide += dw
            if n_live:
                purpose = call_tag * 101 + k
                perms = self._update_orders(r, [purpose], first_k, split)
                pre_model = state.model
                merged = self._receive_slot_apply(
                    state, sr_t[:, k], sender_t[:, k], extra_t[:, k],
                    apply_t[:, k], perms, n_live, (r, purpose))
                if tel is not None:
                    self._slot_telemetry(tel, state, pre_model, sr_t[:, k],
                                         sender_t[:, k], extra_t[:, k],
                                         apply_t[:, k], r, k, merged)
            if hooked and counts[1][k]:
                self._post_receive_slot(state, post[0][:, k], post[1][:, k],
                                        sender_t[:, k], sr_t[:, k],
                                        extra_t[:, k], r, k)
        return n_compact, n_wide

    def _slot_telemetry(self, tel: _SlotTelemetry, state: SimState,
                        pre_model: ModelState, send_round, sender, extra,
                        apply_mask, r: int, k: int, merged) -> None:
        """Fold one delivered slot into ``tel``: the probes
        (:meth:`_probe_slot_update`) and, while no earlier slot has, the
        first slot whose delivery left a non-finite param (on the
        device: no host sync)."""
        if tel.pa is not None:
            tel.pa = self._probe_slot_update(tel.pa, state, pre_model,
                                             send_round, sender, extra,
                                             apply_mask, r, merged)
        if tel.first_bad is not None:
            bad = nonfinite_total(state.model.params, self._leaf_spans) > 0
            tel.first_bad = torch.where((tel.first_bad < 0) & bad,
                                        torch.full_like(tel.first_bad, k),
                                        tel.first_bad)

    def _receive_slot_apply(self, state: SimState, send_round, sender, extra,
                            valid, perms, n_live: int, call):
        """One mailbox slot: the per-slot fused kernel, the compacted pass
        when every live receiver fits the capacity, else the wide pass.
        ``call = (r, purpose)`` names the slot's stream (the JAX engine's
        ``call_key``). Returns the merged rows the per-slot kernel
        produced (before training), or None on the plain path."""
        if self.fused_merge:
            return self._fused_receive(state, send_round, sender, valid,
                                       perms)
        if self._compact_cap is not None and n_live <= self._compact_cap:
            self._apply_receive_compact(state, send_round, sender, extra,
                                        valid, perms, call)
        else:
            self._apply_receive_wide(state, send_round, sender, extra, valid,
                                     perms, call)
        return None

    def _apply_receive_wide(self, state: SimState, send_round, sender, extra,
                            valid, perms, call) -> None:
        peer = self._gather_peer(state, send_round, sender)
        self._apply_receive(state, peer, extra, valid, perms, call)

    def _apply_receive(self, state: SimState, peer: PeerModel, extra, valid,
                       perms, call) -> None:
        """Population-wide :meth:`_receive_rows`, kept where ``valid``."""
        node_ids = torch.arange(self.n_nodes, device=self.device)
        new_model = self._receive_rows(state.model, peer, self._local_data(),
                                       perms, self._decode_extra(extra),
                                       node_ids, call)
        state.model = select_state(valid, new_model, state.model)

    def _apply_receive_compact(self, state: SimState, send_round, sender,
                               extra, valid, perms, call) -> None:
        """The receive pass over a gathered batch of ``cap`` rows that holds
        every live receiver (the stable valid-first argsort), with each
        node's own shard orders; only called when the live count fits.
        The payloads are gathered before they are decoded (a compact-safe
        decode is elementwise)."""
        idx = torch.argsort((~valid).to(torch.int32),
                            stable=True)[:self._compact_cap]
        sub_valid = valid[idx]
        peer = self._gather_peer(state, send_round[idx], sender[idx])
        sub_model = _take_rows(state.model, idx)
        data = tuple(d[idx] for d in self._local_data())
        new_sub = self._receive_rows(sub_model, peer, data,
                                     _take(perms, idx),
                                     self._decode_extra(extra[idx]), idx,
                                     call)
        new_sub = select_state(sub_valid, new_sub, sub_model)
        state.model = _put_rows(state.model, idx, new_sub)

    def _receive_rows(self, models: ModelState, peer: PeerModel, data,
                      perms, extra_arg, node_ids, call) -> ModelState:
        """The handler's receive over row-aligned batches (the population,
        or a gathered subset). Every argument is row-aligned; ``node_ids``
        maps rows to nodes. An override reads per-node state by
        ``node_ids`` and draws per row from the slot's stream ``call``
        (:meth:`DrawProvider.row_uniform`), so that it stays
        compaction-safe."""
        with _scopes.phase_scope(_scopes.PHASE_TRAIN):
            return self.handler.call(models, peer, data, perms, extra_arg)

    def _fused_receive(self, state: SimState, send_round, sender, valid,
                       perms) -> torch.Tensor:
        """MERGE_UPDATE through the single-slot gather-merge kernel (one
        launch over the flat row, where the JAX engine launches once per
        leaf), then the local update of every node with its own optimizer
        state; rows without a live message keep their state. Returns the
        kernel's merged rows."""
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
        with _scopes.phase_scope(_scopes.PHASE_TRAIN):
            updated = self.handler.update(
                ModelState(merged, model.opt_state, ages),
                self._local_data(), perms)
        state.model = select_state(valid, updated, model)
        return merged

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
                                  data) -> tuple[ModelState, torch.Tensor]:
        """One kernel launch and one update over ``model``'s rows: the
        compound left-to-right K-slot blend, age = max over the live
        peers, then the local update with the receiver's optimizer state;
        rows without a live message keep their state. Returns the new
        rows and the kernel's merged params."""
        flat_idx, w_self, w_peer, peer_ages = self._fused_multi_tables(
            state, sr_t, sender_t, apply_t)
        if self.mesh is not None:
            from ..parallel.collectives import sharded_gather_merge_multi
            merged = sharded_gather_merge_multi(
                model.params, state.history_params, flat_idx, w_self, w_peer,
                self.mesh, scales=state.history_scale,
                axis_name=self._fused_ring_axis,
                leaf_starts=(None if state.history_scale is None
                             else self._leaf_starts))
        else:
            ring, scale, starts = self._ring(state)
            merged = gather_merge_multi(model.params, ring, flat_idx, w_self,
                                        w_peer, scale, starts)
        live_ages = torch.where(apply_t, peer_ages,
                                torch.zeros_like(peer_ages)).amax(dim=1)
        ages = torch.maximum(model.n_updates, live_ages)
        with _scopes.phase_scope(_scopes.PHASE_TRAIN):
            updated = self.handler.update(
                ModelState(merged, model.opt_state, ages), data, perms)
        return select_state(row_valid, updated, model), merged

    def _fused_multi_apply(self, state: SimState, sr_t, sender_t, apply_t,
                           perms, any_msg) -> torch.Tensor:
        state.model, merged = self._fused_multi_merge_update(
            state, state.model, sr_t, sender_t, apply_t, perms, any_msg,
            self._local_data())
        return merged

    def _fused_multi_apply_compact(self, state: SimState, sr_t, sender_t,
                                   apply_t, perms, any_msg) -> torch.Tensor:
        """The single pass over ``cap`` gathered rows holding every
        receiver with a live message (the stable valid-first argsort).
        Returns the merged rows scattered over the round-start params
        (only when the probes read them; else None)."""
        idx = torch.argsort((~any_msg).to(torch.int32),
                            stable=True)[:self._compact_cap]
        data = tuple(d[idx] for d in self._local_data())
        pre = state.model.params
        new_sub, merged = self._fused_multi_merge_update(
            state, _take_rows(state.model, idx), sr_t[idx], sender_t[idx],
            apply_t[idx], _take(perms, idx), any_msg[idx], data)
        state.model = _put_rows(state.model, idx, new_sub)
        return pre.index_copy(0, idx, merged) if self._probe_delta_ok \
            else None

    def _fused_multi_dispatch(self, state: SimState, sr_t, sender_t, apply_t,
                              perms, any_msg, n_live: int, occ_slots: int):
        """The compacted single pass when every receiver fits the capacity,
        else the wide one; returns ``(compact, wide, merged)``: the
        cell's occupied-slot count on the path taken, and the kernel's
        merged rows (:meth:`_fused_multi_apply_compact`)."""
        if self._compact_cap is not None and n_live <= self._compact_cap:
            merged = self._fused_multi_apply_compact(state, sr_t, sender_t,
                                                     apply_t, perms, any_msg)
            return occ_slots, 0, merged
        merged = self._fused_multi_apply(state, sr_t, sender_t, apply_t,
                                         perms, any_msg)
        return 0, occ_slots, merged

    def _fused_deliver_all(self, state: SimState, r: int, sr_t, sender_t,
                           apply_t, call_tag: int,
                           tel: Optional[_SlotTelemetry] = None
                           ) -> tuple[int, int]:
        """Single-pass fused deliver of one mailbox cell; each node trains
        under its first live slot's stream (slot ``k``: purpose
        ``call_tag * 101 + k``). ``tel`` gets the cell's accepted counts
        and staleness (every slot at once), the merge and train deltas of
        the compound blend the kernel applied, and, when a param is
        non-finite after the pass, the first occupied slot (the pass has
        no per-slot states to bisect). Returns the (compact, wide) slot
        counts."""
        any_msg = apply_t.any(dim=1)
        n_live, occ_slots = torch.stack(
            [any_msg.sum(), apply_t.any(dim=0).sum()]).tolist()
        if n_live == 0:
            return 0, 0
        first_k = torch.argmax(apply_t.to(torch.int32), dim=1)
        perms = self._update_orders(
            r, [call_tag * 101 + k for k in range(apply_t.shape[1])],
            first_k)
        pre_params = state.model.params
        n_compact, n_wide, merged = self._fused_multi_dispatch(
            state, sr_t, sender_t, apply_t, perms, any_msg, n_live,
            occ_slots)
        if tel is None:
            return n_compact, n_wide
        spans = self._leaf_spans
        if tel.pa is not None:
            tel.pa = tel.pa.record_slot(apply_t, r - sr_t)
            if self._probe_delta_ok:
                merged_p = select_rows(any_msg, merged, pre_params)
                tel.pa = tel.pa.add_deltas(
                    sq_param_distance(merged_p, pre_params, spans),
                    sq_param_distance(state.model.params, merged_p, spans))
        if tel.first_bad is not None:
            bad = nonfinite_total(state.model.params, spans) > 0
            first_occ = torch.argmax(apply_t.any(dim=0).to(torch.int32))
            tel.first_bad = torch.where(bad, first_occ.to(torch.int32),
                                        tel.first_bad)
        return n_compact, n_wide

    def _drain(self, state: SimState, r: int, sr_t, sender_t, apply_t,
               extra_t, call_tag: int, post=None,
               tel: Optional[_SlotTelemetry] = None) -> tuple[int, int]:
        """Apply a mailbox cell's ``[N, K]`` live messages by the
        configured path; returns the (compact, wide) slot counts."""
        if self.fused_merge == "multi":
            return self._fused_deliver_all(state, r, sr_t, sender_t,
                                           apply_t, call_tag, tel)
        return self._slot_loop(state, r, sr_t, sender_t, apply_t, extra_t,
                               call_tag, post, tel)

    def _online(self, r: int, purpose: int):
        """The receivers' availability draw of a drain: ``(online,
        forced)``, where a node a scheduled outage forces offline is never
        online (``forced`` is None without chaos)."""
        online = self.draws.bernoulli(r, purpose, self.online_prob,
                                      self.n_nodes, self.device)
        if self.chaos is None:
            return online, None
        forced = self._chaos_forced_offline(r)
        return online & ~forced, forced

    @staticmethod
    def _receive_fails(occupied_t, online, forced) -> FailureCounts:
        """The messages of a cell lost at their receiver: to a scheduled
        outage (``chaos``) or to the availability draw (``offline``),
        one cause a message."""
        off = occupied_t & ~online[:, None]
        if forced is None:
            return FailureCounts(offline=off.sum())
        hit = occupied_t & forced[:, None]
        return FailureCounts(offline=(off & ~hit).sum(), chaos=hit.sum())

    def _slot_telemetry_start(self, track_bad: bool) -> _SlotTelemetry:
        """A drain's probe accumulator (slot probes on) and first-bad-slot
        sentinel (``track_bad`` and the non-finite sentinel on)."""
        tel = _SlotTelemetry()
        if self._probe_slots_on():
            tel.pa = self._probe_zero_accum()
        if track_bad and self._health_slots_on():
            tel.first_bad = torch.full((), -1, dtype=torch.int32,
                                       device=self.device)
        return tel

    def _deliver_phase(self, state: SimState, r: int):
        """Deliver this round's mailbox cell, queue the replies it asks
        for, then :meth:`_post_deliver`; returns the failure counts, the
        diagnostics of the cell (the probe accumulator and the first bad
        slot among them when those are on), and the replies and extra
        messages sent and their size."""
        D = state.history_ages.shape[0]
        b = r % D
        box = state.mailbox
        online, forced = self._online(r, K_ONLINE)
        sender_t = box.sender[b]
        sr_t = box.send_round[b]
        ty_t = box.msg_type[b]
        occupied_t = sender_t >= 0
        hwm = occupied_t.sum(dim=1).max()
        carries = ((ty_t == MessageType.PUSH) | (ty_t == MessageType.PUSH_PULL)
                   | (ty_t == MessageType.REPLY))
        valid_t = occupied_t & online[:, None]
        apply_t = valid_t & carries
        fails = self._receive_fails(occupied_t, online, forced)
        tel = self._slot_telemetry_start(track_bad=True)
        n_compact, n_wide = self._drain(state, r, sr_t, sender_t, apply_t,
                                        box.extra[b], K_CALL,
                                        (valid_t, ty_t), tel)
        n_replies, reply_size = 0, 0
        if self.protocol != AntiEntropyProtocol.PUSH:
            wants = valid_t & ((ty_t == MessageType.PULL)
                               | (ty_t == MessageType.PUSH_PULL))
            n_replies, fail_q, reply_size = self._queue_replies(
                state, r, sender_t, wants)
            fails = fails + fail_q
        box.clear_cell(b)
        ex_sent, ex_fails, ex_size = self._post_deliver(state, r)
        diag = {"mailbox_hwm": hwm, "compact_slots": n_compact,
                "wide_slots": n_wide, "probe_accum": tel.pa,
                "first_bad_slot": tel.first_bad}
        return fails + ex_fails, diag, n_replies + ex_sent, \
            reply_size + ex_size

    def _queue_replies(self, state: SimState, r: int, sender_t, wants):
        """For each ``[N, K]`` request in ``wants`` a REPLY from its
        receiver to its sender, carrying the receiver's round-``r``
        snapshot, scattered into the reply box slot by slot (slot ``k``
        draws its drops under ``K_REPLY_DROP * 101 + k``, its delays
        under ``K_REPLY_DELAY * 101 + k`` and its payload under
        ``(K_EXTRA + 31) * 101 + k``). A reply counts as sent, with
        the model's size, even when dropped or past the last reply slot.
        Returns ``(n_sent, fails, size)``."""
        n = self.n_nodes
        dev = self.device
        size = self._model_size()
        repliers = torch.arange(n, device=dev)
        n_sent, fails = 0, FailureCounts()
        for k, any_k in enumerate(wants.any(dim=0).tolist()):
            if not any_k:
                continue
            need = wants[:, k]
            dropped = self.draws.bernoulli(r, K_REPLY_DROP * 101 + k,
                                           self._chaos_drop_prob(r), n, dev)
            delays = self._chaos_scale_delays(
                self.delay.sample(self.draws, r, K_REPLY_DELAY * 101 + k, n,
                                  size, dev), r)
            n_sent = n_sent + need.sum()
            n_overflow = self._scatter_messages(
                state.reply_box, need & ~dropped, delays // self.delta,
                sender_t[:, k], repliers, r, int(MessageType.REPLY),
                self._reply_extra(state, r, (K_EXTRA + 31) * 101 + k), r,
                self.Kr)
            fails = fails + FailureCounts(drop=(need & dropped).sum(),
                                          overflow=n_overflow)
        return n_sent, fails, n_sent * size

    def _reply_phase(self, state: SimState, r: int):
        """Drain this round's reply-box cell into the online nodes, by the
        deliver path (slot ``k`` trains under ``(K_CALL + 53) * 101 + k``;
        online draw ``K_ONLINE * 7 + 3``). Returns the failure counts,
        the (compact, wide) slot counts and the probe accumulator (None
        when the slot probes are off)."""
        tel = self._slot_telemetry_start(track_bad=False)
        if self.protocol == AntiEntropyProtocol.PUSH:
            return FailureCounts(), 0, 0, tel.pa
        b = r % state.history_ages.shape[0]
        box = state.reply_box
        online, forced = self._online(r, K_ONLINE * 7 + 3)
        sender_t = box.sender[b]
        sr_t = box.send_round[b]
        occupied_t = sender_t >= 0
        apply_t = occupied_t & online[:, None]
        fails = self._receive_fails(occupied_t, online, forced)
        n_compact, n_wide = self._drain(state, r, sr_t, sender_t, apply_t,
                                        box.extra[b], K_CALL + 53, tel=tel)
        box.clear_cell(b)
        return fails, n_compact, n_wide, tel.pa

    # -- evaluation --------------------------------------------------------

    def _metric_keys(self) -> list:
        if self._metric_names is None:
            self._metric_names = metric_names(self.handler, self.data,
                                              self.device)
        return self._metric_names

    def _n_eval_nodes(self) -> int:
        """How many nodes an evaluation reads: ``max(int(N *
        sampling_eval), 1)`` with sampling, else all of them."""
        if self.sampling_eval > 0:
            return max(int(self.n_nodes * self.sampling_eval), 1)
        return self.n_nodes

    def _eval_phase(self, state: SimState, r: int):
        """Mean local and global metrics over the nodes, or over the
        ``eval_subset`` drawn for round ``r`` with ``sampling_eval``."""
        idx = None
        if self.sampling_eval > 0:
            idx = self.draws.eval_subset(r, self.n_nodes,
                                         self._n_eval_nodes(), self.device)
        return population_metrics(self.handler, state.model.params,
                                  self.data, self._metric_keys(), idx)

    def _maybe_eval(self, state: SimState, r: int, last_round=None):
        """``_eval_phase`` every ``eval_every`` rounds and on the run's last
        round; NaN rows otherwise."""
        due = (r + 1) % self.eval_every == 0 or r == last_round
        if due:
            return self._eval_phase(state, r)
        nan = torch.full((len(self._metric_keys()),), float("nan"),
                         device=self.device)
        return nan, nan

    # -- chaos (opt-in; see simulation.faults) ------------------------------

    def _fc_zeros(self) -> FailureCounts:
        """Zero failure counters with the fourth (``chaos``) counter
        exactly when chaos is configured."""
        return FailureCounts.zeros(chaos_on=self.chaos is not None)

    def _chaos_t(self, r: int) -> int:
        """The schedule row of round ``r`` (rounds at or after the horizon
        read the trailing baseline row)."""
        return min(max(r, 0), self.chaos_schedule.rows - 1)

    def _chaos_forced_offline(self, r: int) -> torch.Tensor:
        """``[N]`` bool: the nodes a scheduled outage forces fully offline
        in round ``r`` (no sends, no receives)."""
        return self._chaos_forced[self._chaos_t(r)]

    def _chaos_drop_prob(self, r: int) -> float:
        """The round's message drop rate: the base rate, or the
        schedule's (possibly spiked) one."""
        if self.chaos is None:
            return self.drop_prob
        return float(self.chaos_schedule.drop_prob[self._chaos_t(r)])

    def _chaos_scale_delays(self, delays: torch.Tensor, r: int
                            ) -> torch.Tensor:
        """The round's scheduled delay spike: ``floor(f32(delay) * s)``,
        as the JAX engine rounds it (the delays themselves without
        chaos or spike)."""
        if self.chaos is None:
            return delays
        s = float(self.chaos_schedule.delay_scale[self._chaos_t(r)])
        if s == 1.0:
            return delays
        return torch.floor(delays.to(torch.float32) * s).to(delays.dtype)

    def _round_adjacency(self, r: int) -> torch.Tensor:
        """The dense adjacency a uniform peer draw of round ``r`` runs
        over: the topology's, ANDed with the round's scheduled edge-alive
        mask under partitions or churn. One masked adjacency per distinct
        mask, made at its first use and kept (a draw provider caches its
        neighbour lists per adjacency tensor)."""
        if not self._chaos_edges:
            return self._adj
        m = int(self.chaos_schedule.mask_idx[self._chaos_t(r)])
        adj = self._chaos_adjs.get(m)
        if adj is None:
            mask = torch.as_tensor(self.chaos_schedule.edge_masks[m],
                                   device=self.device)
            adj = self._chaos_adjs[m] = self._adj & mask
        return adj

    def _topology_peers(self, r: int, sub: int = 0, purpose: int = K_PEER,
                        fold: int = 0) -> torch.Tensor:
        """A uniform peer draw over the topology's own edges, in its form:
        the dense categorical or the CSR ``randint``."""
        if self._sparse:
            return self.draws.csr_peers(r, self._csr, sub=sub,
                                        purpose=purpose, fold=fold)
        return self.draws.peers(r, self._adj, sub=sub, purpose=purpose,
                                fold=fold)

    def _chaos_masked_peers(self, r: int, sub: int = 0,
                            purpose: int = K_PEER) -> torch.Tensor:
        """A uniform peer draw over the round's alive edges: the dense
        adjacency masked by the round's schedule
        (:meth:`_round_adjacency`), or on a sparse topology the alive
        slots of the padded neighbour table; a node whose every edge is
        dead gets peer -1, like an isolated node."""
        if not self._chaos_edges:
            return self._topology_peers(r, sub=sub, purpose=purpose)
        if self._sparse:
            m = int(self.chaos_schedule.mask_idx[self._chaos_t(r)])
            return self.draws.slot_peers(r, self._chaos_nbr,
                                         self._chaos_alive[m], sub=sub,
                                         purpose=purpose)
        return self.draws.peers(r, self._round_adjacency(r), sub=sub,
                                purpose=purpose)

    def _chaos_probes_on(self) -> bool:
        """Whether the round emits the partition-recovery vitals (chaos
        scheduled and the consensus probes on)."""
        return (self.chaos is not None and self.probes is not None
                and self.probes.consensus)

    def _chaos_stats(self, state: SimState, r: int) -> dict:
        return chaos_round_stats(state.model.params,
                                 self._chaos_comp[self._chaos_t(r)],
                                 self._chaos_ncomp, self._leaf_spans)

    # -- probes (opt-in; see telemetry.probes) ------------------------------

    def _probe_slots_on(self) -> bool:
        """Whether the drains fold a probe accumulator (staleness or
        mixing probes on)."""
        return self.probes is not None and (self.probes.staleness
                                            or self.probes.mixing)

    def _probe_zero_accum(self) -> ProbeAccum:
        return ProbeAccum.zeros(self.n_nodes, self.probes.staleness_buckets,
                                self.device)

    def _probe_slot_update(self, pa: ProbeAccum, state: SimState,
                           pre_model: ModelState, send_round, sender, extra,
                           apply_mask, r: int, merged=None) -> ProbeAccum:
        """Fold one slot's accepted merges into the accumulator:
        staleness and counts always; the merge/train deltas where the
        decomposition is exact (``_probe_delta_ok``). ``merged`` is the
        per-slot kernel's own output; on the plain path (None) the
        handler's ``merge`` over the same gather gives the merged rows, as
        the JAX engine recomputes them."""
        pa = pa.record_slot(apply_mask, r - send_round)
        if not self._probe_delta_ok:
            return pa
        if merged is None:
            peer = self._gather_peer(state, send_round, sender)
            extra_arg = self._decode_extra(extra)
            merged = (self.handler.merge(pre_model, peer) if extra_arg is None
                      else self.handler.merge(pre_model, peer,
                                              extra_arg)).params
        spans = self._leaf_spans
        merged_p = select_rows(apply_mask, merged, pre_model.params)
        return pa.add_deltas(
            sq_param_distance(merged_p, pre_model.params, spans),
            sq_param_distance(state.model.params, merged_p, spans))

    def _probe_round_stats(self, state: SimState,
                           pa: Optional[ProbeAccum]) -> dict:
        """The round's ``probe_*`` stats entries, from the round-end state
        and the drains' accumulator."""
        cfg = self.probes
        out: dict = {}
        if cfg.consensus:
            cm, cx, cl = consensus_stats(state.model.params,
                                         self._leaf_spans)
            out["probe_consensus_mean"] = cm
            out["probe_consensus_max"] = cx
            out["probe_consensus_per_layer"] = cl
        if pa is not None:
            out.update(probe_stats_from_accum(cfg, pa, self._probe_delta_ok))
        return out

    def _probe_expected_fanin(self) -> np.ndarray:
        """``[N]`` expected accepted merges per node and round, the
        baseline of ``probe_accepted_per_node``: the expected fan-in
        thinned by the drop and online rates."""
        return (self._lam_vector() * (1.0 - self.drop_prob)
                * self.online_prob)

    def _probe_layer_names(self) -> list[str]:
        """Leaf names of the ``probe_consensus_per_layer`` columns."""
        return param_layer_names(self.handler.layout)

    # -- sentinels (opt-in; see telemetry.health) ---------------------------

    def _health_slots_on(self) -> bool:
        """Whether the deliver drain tracks the first bad slot (the
        non-finite sentinel on)."""
        return self.sentinels is not None and self.sentinels.nonfinite

    def _health_zero_carry(self) -> HealthCarry:
        return HealthCarry.zeros(self.n_nodes, self.device)

    def _health_round(self, hc: HealthCarry, pre_params: torch.Tensor,
                      state: SimState, stats: dict
                      ) -> tuple[HealthCarry, dict]:
        """One round's sentinel vitals, after :meth:`_round` (so every
        variant's round is covered), against the round-start params."""
        return health_round_stats(
            self.sentinels, hc, pre_params, state.model.params,
            stats.get("local"), stats.get("global"), self._leaf_spans,
            mailbox_hwm=stats.get("mailbox_hwm"))

    # -- the round ---------------------------------------------------------

    def _round(self, state: SimState, last_round=None) -> dict:
        """One round, in place; returns the round's stats (0-d tensors and
        metric rows, still on the device)."""
        r = state.round
        # The phase ranges (telemetry.scopes): a profiled run shows named
        # bands; gossipy.train nests inside receive_merge and reply
        # around the handler's update pass. A PUSH round has no reply.
        scope = _scopes.phase_scope
        with scope(_scopes.PHASE_SEND):
            self._pre_send(state, r)
            self._snapshot(state, r)
            n_sent, fail_s, size = self._send_phase(state, r)
        with scope(_scopes.PHASE_RECEIVE_MERGE):
            fail_d, diag, n_replies, reply_size = \
                self._deliver_phase(state, r)
        if self.protocol == AntiEntropyProtocol.PUSH:
            fail_r, reply_compact, reply_wide, reply_pa = \
                self._reply_phase(state, r)
        else:
            with scope(_scopes.PHASE_REPLY):
                fail_r, reply_compact, reply_wide, reply_pa = \
                    self._reply_phase(state, r)
        with scope(_scopes.PHASE_EVAL):
            local, glob = self._maybe_eval(state, r, last_round)
        state.round = r + 1
        fails = self._fc_zeros() + fail_s + fail_d + fail_r
        stats = {
            "sent": n_sent + n_replies,
            "failed": fails.total(),
            "failed_drop": fails.drop,
            "failed_offline": fails.offline,
            "failed_overflow": fails.overflow,
            "mailbox_hwm": diag["mailbox_hwm"],
            "compact_slots": diag["compact_slots"] + reply_compact,
            "wide_slots": diag["wide_slots"] + reply_wide,
            "size": size + reply_size,
            "local": local,
            "global": glob,
        }
        if self.chaos is not None:
            stats["failed_chaos"] = fails.chaos
            if self._chaos_probes_on():
                stats.update(self._chaos_stats(state, r))
        if self.probes is not None:
            pa = None
            if self._probe_slots_on():
                pa = diag["probe_accum"] + reply_pa
            stats.update(self._probe_round_stats(state, pa))
        if self._health_slots_on():
            stats["health_first_bad_slot"] = diag["first_bad_slot"]
        return stats

    def _run_round(self, state: SimState, last_round) -> dict:
        """:meth:`_round`, then the sentinels' vitals against a copy of the
        round-start params (the round replaces the state's tensors; a copy
        keeps the delta right whatever a hook writes in place)."""
        if self.sentinels is None:
            return self._round(state, last_round)
        pre_params = state.model.params.clone()
        stats = self._round(state, last_round)
        self._health_carry, hstats = self._health_round(
            self._health_carry, pre_params, state, stats)
        stats.update(hstats)
        return stats

    def start(self, state: SimState, n_rounds: int = 100,
              profile_dir: Optional[str] = None, mesh=None
              ) -> tuple[SimState, SimulationReport]:
        """Run ``n_rounds`` rounds on ``state`` (in place); returns the
        state and a report. The per-round counters stay on the device
        until the run ends, unless a live receiver is attached: each
        round is then copied to the host and notified as it ends. After
        the run, the other receivers get every round replayed.

        ``profile_dir`` runs the rounds under ``torch.profiler`` (CPU
        activity, and CUDA activity on the card) and exports its Chrome
        trace into the directory (:meth:`_profiled_rounds`).

        With ``tracing=`` the call is an ``engine.start`` span (a run
        window: ``round_start``, ``rounds``) holding ``engine.run`` (a
        wait, closed after the card is synchronised, with one
        ``device.execute`` span laid under it, or one span a phase from
        the profiler trace of ``profile_dir``) and ``engine.report``.
        With ``perf=`` timing or ``tracing=``, the card is synchronised
        once when the rounds end; otherwise not at all until the report
        copies the counters. The digest row of ``ledger=`` is appended
        after the report.

        In cohort mode ``state`` is the resident :class:`~gossipy_tpu_torch.
        simulation.cohort.CohortPool` and the call is the host-driven
        gather -> [C]-round -> scatter segment loop
        (:func:`~gossipy_tpu_torch.simulation.cohort.cohort_start`;
        ``profile_dir`` does not apply); returns ``(pool, report)``.
        ``mesh`` (cohort mode only) places each segment's ``[C]`` state
        and data rows per the partition-rule registry
        (:mod:`~gossipy_tpu_torch.parallel.rules`); C must divide the
        mesh's node axis."""
        if self.cohort is not None:
            from .cohort import cohort_start
            out = cohort_start(self, state, n_rounds, mesh=mesh)
            self._ledger_append(out[1], n_rounds, None,
                                round_start=int(state.round))
            return out
        if mesh is not None:
            raise ValueError(
                "start(mesh=) is the cohort-mode sharded-round path; for "
                "materialized populations place the state up front with "
                "parallel.shard_state(state, mesh)")
        tr = self.tracer
        first_round = state.round
        perf_timing = self.perf is not None and self.perf.timing
        cuda = self.device.type == "cuda"
        if self.perf is not None and self.perf.cost and cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        loaded = len(_build._LOADED)
        with span("engine.start", cat="engine", tracer=tr,
                  round_start=first_round, rounds=n_rounds):
            with span("engine.run", cat=WAIT_CAT, tracer=tr) as sp_run:
                if profile_dir is None:
                    rows = self._run_rounds(state, n_rounds)
                else:
                    rows = self._profiled_rounds(state, n_rounds,
                                                 profile_dir)
                if cuda and (perf_timing or tr is not None):
                    torch.cuda.synchronize(self.device)
            exec_seconds = sp_run.duration
            # A kernel built or loaded during the run folds its build
            # into the measured time.
            cold = len(_build._LOADED) != loaded
            if tr is not None:
                phase_ms = None
                if profile_dir is not None:
                    try:
                        phase_ms = phase_times_from_trace(profile_dir)
                    except Exception:
                        phase_ms = None
                attach_device_spans(tr, sp_run.ts_us, sp_run.dur_us,
                                    phase_ms=phase_ms,
                                    args={"n_rounds": n_rounds})
            with span("engine.report", cat="engine", tracer=tr):
                report = self._finish_run(
                    first_round, rows, n_rounds,
                    exec_seconds if perf_timing else None, cold)
        # Outside the run window: the digest append is ledger
        # bookkeeping. exec_seconds measured the run only when the card
        # was synchronised before the clock stopped.
        self._ledger_append(report, n_rounds,
                            exec_seconds if (perf_timing or tr is not None)
                            else None, round_start=first_round)
        return state, report

    def _profiled_rounds(self, state: SimState, n_rounds: int,
                         profile_dir: str) -> list:
        """:meth:`_run_rounds` under ``torch.profiler`` (CPU activity,
        and CUDA activity on the card, synchronised before the profiler
        stops), its Chrome trace exported as ``<simulator>_r<first
        round>_<ns>.json`` into ``profile_dir``
        (:func:`~gossipy_tpu_torch.telemetry.cost.phase_times_from_trace`
        reads it)."""
        import time as _time

        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        name = (f"{type(self).__name__}_r{state.round}_"
                f"{_time.time_ns()}.json")
        with profile(activities=activities) as prof:
            rows = self._run_rounds(state, n_rounds)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, name))
        return rows

    def _run_rounds(self, state: SimState, n_rounds: int) -> list:
        """The rounds of one :meth:`start` call: their stats rows, still
        on the device (a live receiver gets each as it ends)."""
        last = state.round + n_rounds - 1
        if self.sentinels is not None and self._health_carry is None:
            self._health_carry = self._health_zero_carry()
        live = self.has_live_receivers()
        rows = []
        for _ in range(n_rounds):
            rows.append(self._run_round(state, last))
            if live:
                self._emit_live(state.round, rows[-1])
        return rows

    def _finish_run(self, first_round: int, rows: list, n_rounds: int,
                    exec_seconds: Optional[float] = None,
                    cold: bool = False, extra: Optional[dict] = None,
                    include_live: bool = False) -> SimulationReport:
        """The rows on the host (with the host arrays ``extra``: a cohort
        run's accounting), the ``perf_*`` rows (when ``perf=`` timed the
        run), the report, the metrics feed, the replayed events (to the
        live receivers too with ``include_live``)."""
        stats = {}
        for k in rows[0] if rows else ():
            vals = [torch.as_tensor(row[k], device=self.device) for row in rows]
            stats[k] = torch.stack(vals).cpu().numpy()
        stats.update(extra or {})
        if self.perf is not None and self.perf.cost:
            self._record_cost(n_rounds)
        if exec_seconds is not None:
            self._attach_perf_stats(stats, n_rounds, exec_seconds, cold)
        report = self._build_report(stats, n_rounds)
        if self.metrics_enabled:
            self._feed_metrics(stats, report, n_rounds)
        if rows:
            self.replay_events(first_round, stats, self._metric_keys(),
                               include_live=include_live)
        return report

    # -- performance observability (telemetry.cost; host side only) ---------

    def _device_kind(self) -> Optional[str]:
        """The card's name (``torch.cuda.get_device_name``), or ``"cpu"``
        for a CPU simulator."""
        if self.device.type != "cuda":
            return "cpu"
        return current_device_kind()

    def _record_cost(self, n_rounds: int) -> None:
        """Bank this ``start()``'s :class:`~gossipy_tpu_torch.telemetry.
        cost.CostReport`: the XLA fields None, the call's peak allocation
        in ``extra`` (None on the CPU)."""
        peak = (int(torch.cuda.max_memory_allocated(self.device))
                if self.device.type == "cuda" else None)
        self._cost_reports.append(CostReport(
            label=f"start[{n_rounds}r]", n_rounds=n_rounds,
            extra={"max_memory_allocated": peak}))

    def _analytic_cost(self) -> Optional[dict]:
        """:func:`~gossipy_tpu_torch.telemetry.cost.analytic_round_cost`,
        counted once per simulator, when it is built with ``perf=`` (on
        ``meta`` tensors: no allocation, no launch, no draw)."""
        if self._analytic is None:
            self._analytic = analytic_round_cost(self) or {}
        return self._analytic or None

    def _attach_perf_stats(self, stats: dict, n_rounds: int,
                           exec_seconds: float, cold: bool) -> dict:
        """Stamp the run's measured time into ``stats`` as per-round
        ``perf_*`` rows (uniform within this ``start()``) and remember
        the summary for :meth:`perf_summary`."""
        per_round_s = exec_seconds / max(n_rounds, 1)
        # The MFU numerator: the analytic count (the JAX engine reads
        # XLA's count of the compiled round).
        analytic = self._analytic_cost()
        flops_pr = analytic["flops_per_round"] if analytic else None
        mfu = mfu_estimate(flops_pr, per_round_s, self._device_kind())
        stats["perf_round_ms"] = np.full((n_rounds,), per_round_s * 1e3,
                                         np.float64)
        stats["perf_mfu_est"] = np.full(
            (n_rounds,), np.nan if mfu is None else mfu, np.float32)
        self._perf_last = {
            "rounds": n_rounds,
            "seconds": exec_seconds,
            "ms_per_round": per_round_s * 1e3,
            "mfu_est": mfu,
            "flops_per_round": flops_pr,
            # A kernel built during the run folds its build into the
            # measurement.
            "cold": bool(cold),
        }
        return stats

    def _feed_metrics(self, stats: dict, report, n_rounds: int) -> dict:
        """The metrics feed of one finished segment (``metrics=True``):
        the process registry's engine counters from the report's
        per-cause failure arrays, and per-round CUMULATIVE counter rows
        (over the simulator's lifetime, so chunked runs keep monotone
        counters across ``start()`` calls) for the JSONL ``metrics``
        field."""
        sent = np.asarray(report.sent_per_round, np.int64)
        failed = np.asarray(report.failed_per_round, np.int64)
        if report.failed_per_cause is not None:
            by_cause = {c: float(np.asarray(a).sum())
                        for c, a in report.failed_per_cause.items()}
        else:
            by_cause = {"all": float(failed.sum())}
        observe_engine_run(type(self).__name__, n_rounds,
                           float(sent.sum()), by_cause)
        base = self._metrics_base
        sent_cum = base["sent"] + np.cumsum(sent)
        failed_cum = base["failed"] + np.cumsum(failed)
        stats["metrics_rows"] = [
            {"rounds_total": base["rounds"] + i + 1,
             "sent_total": int(sent_cum[i]),
             "failed_total": int(failed_cum[i])}
            for i in range(n_rounds)]
        base["rounds"] += n_rounds
        base["sent"] = int(sent_cum[-1]) if n_rounds else base["sent"]
        base["failed"] = int(failed_cum[-1]) if n_rounds else base["failed"]
        return stats

    def perf_summary(self) -> Optional[dict]:
        """The manifest and bundle-verdict ``perf`` block (None when
        ``perf=`` is off), with the JAX engine's keys: the banked
        reports, the analytic estimate, the last run's timing and MFU,
        and the peak table's entry for the card. The port compiles
        nothing: ``compile_count`` is 0, ``flops_per_round_xla`` and
        ``bytes_per_round_xla`` are None (and there is no
        ``analytic_vs_xla_flops_ratio``); ``hbm_peak_bytes`` is the
        largest banked ``max_memory_allocated``. Null-safe: a CPU run
        reports its FLOPs with a null MFU (no peak)."""
        if self.perf is None:
            return None
        kind = self._device_kind()
        analytic = self._analytic_cost() if self.perf.analytic else None
        peaks = [cr.extra.get("max_memory_allocated")
                 for cr in self._cost_reports]
        return {
            "config": self.perf.to_dict(),
            "device_kind": kind,
            "peak_flops": peak_flops(kind),
            "compile_count": 0,
            "flops_per_round_xla": None,
            "bytes_per_round_xla": None,
            "hbm_peak_bytes": max((p for p in peaks if p is not None),
                                  default=None),
            "analytic": analytic,
            "last_run": self._perf_last,
            "programs": [cr.to_dict() for cr in self._cost_reports],
        }

    def _ledger_append(self, report, n_rounds: int,
                       exec_seconds: Optional[float],
                       round_start: Optional[int] = None) -> Optional[dict]:
        """Append this segment's digest row to the run ledger (no-op
        without one). Host side, after the run, best-effort: never raises
        into a finished run. Segments of one chunked run share the
        simulator's ledger run id."""
        if self.ledger is None:
            return None
        try:
            metrics: dict = {}
            if exec_seconds and exec_seconds > 0:
                metrics["rounds_per_sec"] = round(n_rounds / exec_seconds,
                                                  3)
            perf_last = self._perf_last or {}
            metrics["mfu_est"] = perf_last.get("mfu_est")
            for name in ("accuracy", "auc", "f1"):
                acc = report.final(name)
                if acc == acc:  # the first non-NaN eval metric
                    metrics["final_accuracy"] = acc
                    break
            extra = {"rounds": int(n_rounds)}
            if round_start is not None:
                extra["round_start"] = int(round_start)
            row = ingest_manifest(
                self.ledger, self.run_manifest(), kind="engine",
                run_id=self._ledger_run_id, metrics=metrics, extra=extra)
            self._ledger_run_id = row["run_id"]
            return row
        except Exception:
            return None

    def _emit_live(self, round_no: int, row: dict) -> None:
        """Notify the live receivers of one finished round (1-based
        ``round_no``): its counters copied to the host, the payloads built
        as the replay builds them."""
        vals = {k: torch.as_tensor(v).cpu().numpy() for k, v in row.items()}
        names = self._metric_keys()
        causes = {c: int(vals["failed_" + c])
                  for c in ("drop", "offline", "overflow")}
        if "failed_chaos" in vals:
            causes["chaos"] = int(vals["failed_chaos"])

        def pick(keys):
            return {k: vals[k] for k in keys if k in vals}

        def metrics(v: np.ndarray):
            if np.all(np.isnan(v)):
                return None
            return {k: float(x) for k, x in zip(names, v)}
        self._notify_round(
            round_no, int(vals["sent"]), int(vals["failed"]),
            int(vals["size"]), metrics(vals["local"]),
            metrics(vals["global"]), live_only=True, causes=causes,
            probes=probe_event_row(pick(PROBE_STAT_KEYS)),
            health=health_event_row(pick(HEALTH_STAT_KEYS)),
            chaos=chaos_event_row(pick(("failed_chaos",)
                                       + CHAOS_PROBE_KEYS)))
        if "health_trip" in vals and int(vals["health_trip"]) > 0:
            # The JAX engine's sentinel_trip leaves the running program
            # by a host callback; here it is sent once the tripped
            # round's values are on the host.
            nf = vals.get("health_nonfinite_params")
            emit_event("sentinel_trip", {
                "round": int(round_no),
                "nonfinite_params": int(np.sum(nf)) if nf is not None
                else 0,
                "simulator": type(self).__name__})

    def run_repetitions(self, n_rounds: int, seeds, local_train: bool = True,
                        common_init: bool = False, draws=None
                        ) -> tuple[list, list]:
        """Independent simulations, one after another: repetition ``i``
        is :meth:`init_nodes` under ``torch.Generator().manual_seed(
        seeds[i])`` then :meth:`start` for ``n_rounds`` rounds, drawing
        from ``draws[i]`` (default ``TorchDraws(seeds[i])``). Returns the
        final states and one report each. The JAX engine runs them as one
        vmapped program from split keys; the simulator's own draw
        provider is restored afterwards."""
        if self.cohort is not None:
            raise ValueError("cohort mode is host-driven per segment; run "
                             "start() per seed against separate pools")
        if draws is not None and len(draws) != len(seeds):
            raise ValueError(f"{len(draws)} draw providers for "
                             f"{len(seeds)} repetitions")
        saved = self.draws
        states, reports = [], []
        try:
            for i, seed in enumerate(seeds):
                self.draws = (draws[i] if draws is not None
                              else TorchDraws(int(seed)))
                state = self.init_nodes(
                    torch.Generator().manual_seed(int(seed)),
                    local_train=local_train, common_init=common_init)
                state, report = self.start(state, n_rounds)
                states.append(state)
                reports.append(report)
        finally:
            self.draws = saved
        return states, reports

    def _build_report(self, stats: dict, n_rounds: int) -> SimulationReport:
        m = len(self._metric_keys())
        empty_i = np.zeros((n_rounds,), np.int64)

        def get(k, default):
            return stats.get(k, default)
        causes = {"drop": get("failed_drop", empty_i),
                  "offline": get("failed_offline", empty_i),
                  "overflow": get("failed_overflow", empty_i)}
        if self.chaos is not None:
            causes["chaos"] = get("failed_chaos", empty_i)
        extras = {k: stats[k] for k in PROBE_STAT_KEYS + HEALTH_STAT_KEYS
                  + CHAOS_PROBE_KEYS + PERF_STAT_KEYS + COHORT_STAT_KEYS
                  if k in stats}
        if self.probes is not None:
            if self.probes.consensus:
                extras["probe_layer_names"] = self._probe_layer_names()
            if self.probes.mixing:
                extras["probe_expected_fanin"] = np.asarray(
                    self._probe_expected_fanin(), np.float64)
        if self._health_slots_on():
            extras["health_layer_names"] = self._probe_layer_names()
        report = SimulationReport(
            metric_names=self._metric_keys(),
            local_evals=(get("local", np.zeros((0, m)))
                         if self.has_local_test else None),
            global_evals=(get("global", np.zeros((0, m)))
                          if self.has_global_eval else None),
            sent=get("sent", empty_i),
            failed=get("failed", empty_i),
            total_size=int(np.asarray(get("size", empty_i)).sum()),
            failed_by_cause=causes,
            mailbox_hwm=get("mailbox_hwm", empty_i),
            compact_slots=get("compact_slots", empty_i),
            wide_slots=get("wide_slots", empty_i),
            **extras,
        )
        if self.probes is not None:
            self._emit_probe_summary(report)
        return report

    def _emit_probe_summary(self, report: SimulationReport) -> None:
        """One ``probes_summary`` sink event per built report: the run's
        gossip dynamics in brief (the per-round detail lives in the
        report and the ``update_probes`` events)."""
        data: dict = {"simulator": type(self).__name__,
                      "probes": self.probes.to_dict()}
        cm = report.probe_consensus_mean
        if cm is not None and len(cm):
            data["consensus_first"] = float(cm[0])
            data["consensus_last"] = float(cm[-1])
        if report.probe_stale_max is not None and len(report.probe_stale_max):
            data["stale_max"] = int(np.max(report.probe_stale_max))
        acc = report.probe_accepted_per_node
        if acc is not None:
            data["accepted_total"] = int(np.sum(acc))
        emit_event("probes_summary", data)
