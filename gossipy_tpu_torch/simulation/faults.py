"""Chaos layer: scheduled fault injection for gossip simulations.

Counterpart of ``gossipy_tpu/simulation/faults.py``. The declarative
config, its episodes and :func:`build_fault_schedule` are a copy of the
JAX module's numpy code, so the two packages compile one config into equal
tables (churn draws from ``np.random.default_rng((seed, epoch))``); the
engine moves the tables to the device once. :func:`chaos_round_stats`
works over the port's flat ``[N, stride]`` rows.

- :class:`ChaosConfig`: what goes wrong when: :class:`OutageEpisode`
  (node groups forced offline for contiguous round windows),
  :class:`PartitionEpisode` (the graph split into components for rounds
  ``[start, stop)`` then healed), :class:`ChurnProcess` (per-epoch
  rewiring within the static adjacency) and :class:`FaultSpike`
  (per-round overrides of ``drop_prob`` and a delay scale).
- :func:`build_fault_schedule`: the per-round tables, indexed by the
  absolute round. Edge effects (partitions + churn) compose into a small
  set of deduplicated ``[M, N, N]`` edge-alive masks plus a per-round
  index on a dense topology; on a sparse one, per-edge masks in CSR
  order (``[M, 2E]``) and per-slot masks of the padded neighbour table
  (``[M, N, max_deg]``), O(E) each.
- :func:`chaos_round_stats`: per-round partition consensus gap,
  within-component mixing and live component count.
- :func:`rounds_to_reconverge`: how many rounds after a heal the gap
  took to close.

Everything is opt-in (``GossipSimulator(chaos=...)``). Semantics, as in
the JAX package:

- A forced-offline node neither SENDS nor RECEIVES while its window is
  active, unlike the ``online_prob`` draw which only gates receipt.
  Delivery failures on forced-offline receivers count under the
  ``"chaos"`` failure cause; the random availability draw keeps
  ``"offline"``.
- Partitions/churn sever links at SEND time (a sender never picks a dead
  edge); messages already in flight when a partition starts still drain.
- Rounds at or beyond the schedule ``horizon`` read a trailing baseline
  row: no forced outages, all edges alive, base fault rates.
- On a mesh across ranks every rank holds the whole tables: the sends
  and the peer draws are the whole population's on every rank, a rank's
  receivers read their rows of the outage table, the ``"chaos"``
  failures are summed over the ranks, and :func:`chaos_round_stats`
  groups every node's rows (gathered), as one process does. An outage
  of one rank's every node hangs nothing: the deliver's path is picked
  from counts summed over the ranks.
- On the card :func:`chaos_round_stats`' per-component sums
  (``index_add_``) add with atomics in no fixed order: two runs may
  differ in the last bits of the gap and the within-component mean.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Union

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Declarative config
# ---------------------------------------------------------------------------

def _check_window(start: int, stop: int, what: str) -> None:
    if not (0 <= start < stop):
        raise ValueError(f"{what} window must satisfy 0 <= start < stop, "
                         f"got [{start}, {stop})")


@dataclasses.dataclass(frozen=True)
class OutageEpisode:
    """A correlated outage: ``nodes`` are forced offline (no sends, no
    receives) for rounds ``[start, stop)``, replacing the independent
    per-round availability draw for those nodes while scheduled."""

    nodes: tuple
    start: int
    stop: int

    def __post_init__(self):
        _check_window(self.start, self.stop, "outage")
        object.__setattr__(self, "nodes", tuple(int(n) for n in self.nodes))
        if not self.nodes:
            raise ValueError("an outage episode needs at least one node")


@dataclasses.dataclass(frozen=True)
class PartitionEpisode:
    """A network partition: for rounds ``[start, stop)`` only edges whose
    endpoints share a component stay alive; the graph heals at ``stop``.
    ``components`` are disjoint node-id groups; nodes listed in no group
    form one implicit extra component. Overlapping partition windows:
    the LAST episode in the config wins per round."""

    components: tuple
    start: int
    stop: int

    def __post_init__(self):
        _check_window(self.start, self.stop, "partition")
        comps = tuple(tuple(int(n) for n in c) for c in self.components)
        object.__setattr__(self, "components", comps)
        if len(comps) < 1:
            raise ValueError("a partition needs at least one component")
        seen: set = set()
        for c in comps:
            if seen & set(c):
                raise ValueError("partition components must be disjoint")
            seen |= set(c)


@dataclasses.dataclass(frozen=True)
class ChurnProcess:
    """Edge churn within the static superset adjacency: every ``period``
    rounds of the window ``[start, stop)`` a fresh uniform subset of
    ``keep_frac`` of the topology's (undirected) edges is drawn alive;
    the rest are down until the next epoch. Deterministic per
    ``(seed, epoch)``."""

    keep_frac: float
    start: int
    stop: int
    period: int = 1
    seed: int = 0

    def __post_init__(self):
        _check_window(self.start, self.stop, "churn")
        if not 0.0 <= self.keep_frac <= 1.0:
            raise ValueError("keep_frac must be in [0, 1], got "
                             f"{self.keep_frac}")
        if self.period < 1:
            raise ValueError("churn period must be >= 1")


@dataclasses.dataclass(frozen=True)
class FaultSpike:
    """A piecewise-constant fault-rate override for rounds
    ``[start, stop)``: ``drop_prob`` replaces the simulator's base
    per-message drop rate (None = keep the base), ``delay_scale``
    multiplies every sampled message delay (floor-rounded)."""

    start: int
    stop: int
    drop_prob: Optional[float] = None
    delay_scale: float = 1.0

    def __post_init__(self):
        _check_window(self.start, self.stop, "spike")
        if self.drop_prob is not None and not 0.0 <= self.drop_prob <= 1.0:
            raise ValueError("spike drop_prob must be in [0, 1], got "
                             f"{self.drop_prob}")
        if self.delay_scale <= 0.0:
            raise ValueError("delay_scale must be > 0")


_EPISODE_KINDS = {"outages": OutageEpisode, "partitions": PartitionEpisode,
                  "spikes": FaultSpike}


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """A full chaos scenario: which faults hit which rounds.

    ``horizon`` bounds the schedule tables (rounds beyond it are
    baseline); None derives it as the max ``stop`` over every episode.
    JSON-able via :meth:`to_dict` / :meth:`from_dict`, in the JAX
    package's form.
    """

    outages: tuple = ()
    partitions: tuple = ()
    churn: Optional[ChurnProcess] = None
    spikes: tuple = ()
    horizon: Optional[int] = None

    def __post_init__(self):
        for name, cls in _EPISODE_KINDS.items():
            eps = tuple(ep if isinstance(ep, cls) else cls(**ep)
                        for ep in getattr(self, name))
            object.__setattr__(self, name, eps)
        if self.churn is not None and not isinstance(self.churn,
                                                     ChurnProcess):
            object.__setattr__(self, "churn", ChurnProcess(**self.churn))
        if not (self.outages or self.partitions or self.churn is not None
                or self.spikes):
            raise ValueError("an empty ChaosConfig schedules nothing; pass "
                             "chaos=None instead")
        stops = [ep.stop for ep in self.outages + self.partitions
                 + self.spikes]
        if self.churn is not None:
            stops.append(self.churn.stop)
        derived = max(stops)
        if self.horizon is None:
            object.__setattr__(self, "horizon", derived)
        elif self.horizon < derived:
            raise ValueError(f"horizon {self.horizon} does not cover the "
                             f"latest episode stop {derived}")

    # -- coercion / serialization -------------------------------------------

    @classmethod
    def coerce(cls, chaos: Union[None, dict, "ChaosConfig"]
               ) -> Optional["ChaosConfig"]:
        """Normalize the ``chaos=`` constructor argument: ``None`` → off,
        a dict → :meth:`from_dict`, a :class:`ChaosConfig` → itself."""
        if chaos is None:
            return None
        if isinstance(chaos, cls):
            return chaos
        if isinstance(chaos, dict):
            return cls.from_dict(chaos)
        raise TypeError("chaos= expects None, dict or ChaosConfig; got "
                        f"{type(chaos).__name__}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ChaosConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown chaos fields: {sorted(unknown)}; "
                             f"valid: {sorted(known)}")
        return cls(**d)

    # -- static facts the engines need at construction ----------------------

    def max_delay_scale(self) -> float:
        """Worst-case delay multiplier (sizes the history ring)."""
        return max([1.0] + [sp.delay_scale for sp in self.spikes])

    def max_components(self) -> int:
        """Static component count for the in-graph chaos stats: the max
        over partition windows of (listed components + the implicit
        unlisted group), floor 1."""
        return max([1] + [len(p.components) + 1 for p in self.partitions])

    def has_edge_faults(self) -> bool:
        return bool(self.partitions) or self.churn is not None



# ---------------------------------------------------------------------------
# The compiled schedule
# ---------------------------------------------------------------------------

class FaultSchedule(NamedTuple):
    """Per-round fault tables, indexed by the absolute round number
    clamped to the trailing baseline row (``horizon``); numpy on the
    host. The fields and their meaning are the JAX module's.

    ``edge_masks`` (dense topologies) or ``csr_masks`` and ``slot_masks``
    (sparse topologies) hold the deduplicated edge-alive masks;
    ``mask_idx[t]`` picks the round's mask (0 = baseline, everything
    alive). Masks are modifiers: the engine ANDs them with the base
    adjacency, so a True entry on a non-edge is inert.
    """

    forced_offline: Any   # [T+1, N] bool: node scheduled offline this round
    drop_prob: Any        # [T+1] f32: per-round message drop rate
    delay_scale: Any      # [T+1] f32: per-round delay multiplier
    mask_idx: Any         # [T+1] i32: edge-mask index (0 = baseline)
    component_id: Any     # [T+1, N] i32: scheduled partition component
    edge_masks: Any = ()  # [M, N, N] bool (dense topology) | ()
    csr_masks: Any = ()   # [M, 2E] bool, CSR directed-edge order | ()
    slot_masks: Any = ()  # [M, N, max_deg] bool, padded neighbour slots | ()

    @property
    def rows(self) -> int:
        return self.forced_offline.shape[0]


def schedule_shape_summary(sched: FaultSchedule) -> dict:
    """Shapes and dtypes of a schedule's arrays, the part of a chaos
    config that decides a service bucket (the values are the tenant's
    own): ``{field: [shape, dtype] or None}``, the JAX function's dict
    (the schedule's tables are numpy on the host)."""
    out = {}
    for name, v in sched._asdict().items():
        out[name] = (None if isinstance(v, tuple)
                     else [list(np.shape(v)), str(np.asarray(v).dtype)])
    return out


def _undirected_pairs(topology):
    """(pi, pj) int64 arrays of the topology's undirected edges, sorted
    lexicographically: the canonical pair ordering every churn draw and
    mask derives from (the JAX module's, equal for dense and CSR
    topologies)."""
    from ..core import SparseTopology
    if isinstance(topology, SparseTopology):
        src = np.repeat(np.arange(topology.num_nodes, dtype=np.int64),
                        np.asarray(topology.degrees, dtype=np.int64))
        dst = topology.indices.astype(np.int64)
        keep = src < dst
        pi, pj = src[keep], dst[keep]
    else:
        pi, pj = np.nonzero(np.triu(np.asarray(topology.adjacency)))
        pi, pj = pi.astype(np.int64), pj.astype(np.int64)
    order = np.lexsort((pj, pi))
    return pi[order], pj[order]


def build_fault_schedule(cfg: ChaosConfig, topology,
                         base_drop_prob: float) -> FaultSchedule:
    """Compile ``cfg`` against a topology into host-side numpy tables
    (the engine moves them to its device once)."""
    from ..core import SparseTopology
    T = int(cfg.horizon)
    n = topology.num_nodes
    rows = T + 1  # trailing baseline row, read by rounds >= horizon

    forced = np.zeros((rows, n), dtype=bool)
    for ep in cfg.outages:
        forced[ep.start:min(ep.stop, T), list(ep.nodes)] = True

    drop = np.full(rows, float(base_drop_prob), dtype=np.float32)
    scale = np.ones(rows, dtype=np.float32)
    for sp in cfg.spikes:
        sl = slice(sp.start, min(sp.stop, T))
        if sp.drop_prob is not None:
            drop[sl] = sp.drop_prob
        scale[sl] = sp.delay_scale

    # Component ids PERSIST past the partition's heal (until a later
    # partition overwrites them): the recovery probe keeps measuring the
    # gap between the FORMER components after the edges heal, so
    # ``chaos_component_gap`` visibly decays to ~0 instead of snapping to
    # a structural zero the moment the window closes. Edge masks below
    # still heal exactly at ``stop``.
    comp = np.zeros((rows, n), dtype=np.int32)
    for p in cfg.partitions:
        ids = np.full(n, len(p.components), dtype=np.int32)  # implicit grp
        for g, grp in enumerate(p.components):
            ids[list(grp)] = g
        comp[p.start:] = ids

    mask_idx = np.zeros(rows, dtype=np.int32)
    edge_masks: Any = ()
    csr_masks: Any = ()
    slot_masks: Any = ()
    if cfg.has_edge_faults():
        pi, pj = _undirected_pairs(topology)
        n_pairs = len(pi)
        pair_alive_rows = [np.ones(n_pairs, dtype=bool)]  # mask 0: baseline
        seen = {pair_alive_rows[0].tobytes(): 0}
        churn = cfg.churn
        churn_cache: dict = {}

        def churn_alive(epoch: int) -> np.ndarray:
            if epoch not in churn_cache:
                rng = np.random.default_rng((int(churn.seed), int(epoch)))
                churn_cache[epoch] = rng.random(n_pairs) < churn.keep_frac
            return churn_cache[epoch]

        part_active = np.zeros(T, dtype=bool)
        for p in cfg.partitions:
            part_active[p.start:min(p.stop, T)] = True
        for r in range(T):
            churn_on = (churn is not None
                        and churn.start <= r < churn.stop)
            if not (part_active[r] or churn_on):
                continue
            alive = np.ones(n_pairs, dtype=bool)
            if part_active[r]:
                alive &= comp[r, pi] == comp[r, pj]
            if churn_on:
                alive &= churn_alive((r - churn.start) // churn.period)
            key = alive.tobytes()
            if key not in seen:
                seen[key] = len(pair_alive_rows)
                pair_alive_rows.append(alive)
            mask_idx[r] = seen[key]

        pair_alive = np.stack(pair_alive_rows)  # [M, n_pairs]
        m_count = pair_alive.shape[0]
        if isinstance(topology, SparseTopology):
            # Directed CSR edge order (rows ascending, neighbours sorted):
            # each directed edge takes its unordered pair's draw.
            src = np.repeat(np.arange(n, dtype=np.int64),
                            np.asarray(topology.degrees, dtype=np.int64))
            dst = topology.indices.astype(np.int64)
            lo, hi = np.minimum(src, dst), np.maximum(src, dst)
            pair_key = pi * n + pj
            order = np.argsort(pair_key)
            pos = np.searchsorted(pair_key[order], lo * n + hi)
            csr_masks = pair_alive[:, order[pos]]   # [M, 2E]
            # The padded slot form: slot s of row i is edge indptr[i] + s.
            degrees = np.asarray(topology.degrees, dtype=np.int64)
            max_deg = max(int(degrees.max()) if n else 0, 1)
            slot_masks = np.zeros((m_count, n, max_deg), dtype=bool)
            pos_e = np.arange(len(src)) - topology.indptr[src]
            slot_masks[:, src, pos_e] = csr_masks
        else:
            dense = np.ones((m_count, n, n), dtype=bool)
            dense[:, pi, pj] = pair_alive
            dense[:, pj, pi] = pair_alive
            edge_masks = dense

    return FaultSchedule(
        forced_offline=forced,
        drop_prob=drop,
        delay_scale=scale,
        mask_idx=mask_idx,
        component_id=comp,
        edge_masks=edge_masks,
        csr_masks=csr_masks,
        slot_masks=slot_masks,
    )


# ---------------------------------------------------------------------------
# In-graph chaos stats (recovery evidence)
# ---------------------------------------------------------------------------

# Per-round chaos stat keys the engines emit when chaos + consensus probes
# are on (report registry fields, JSONL ``chaos`` row, ``update_chaos``
# observer event). ``failed_chaos`` — the fourth failure cause — travels
# with the cause breakdown instead.
CHAOS_PROBE_KEYS = ("chaos_component_gap", "chaos_within_mean",
                    "chaos_active_components")


def chaos_round_stats(params: torch.Tensor, component_id: torch.Tensor,
                      n_components: int, spans) -> dict:
    """One round's partition-recovery vitals over ``[N, stride]`` rows
    (their leaf columns, ``spans``), grouped by the round's SCHEDULED
    component ids (``[N]`` on the rows' device):

    - ``chaos_component_gap``: max pairwise L2 distance between the mean
      parameter vectors of the non-empty components (0 with a single
      component): it OPENS while a partition holds and RECONVERGES to ~0
      after the heal;
    - ``chaos_within_mean``: mean over nodes of the L2 distance to their
      own component's mean (per-component mixing health);
    - ``chaos_active_components``: how many scheduled components hold at
      least one node this round.

    ``n_components`` is ``ChaosConfig.max_components()``. The per-component
    sums are ``index_add_`` where the JAX module has ``segment_sum``.
    """
    n = params.shape[0]
    flat = torch.cat([params[:, o:o + w].to(torch.float32)
                      for o, w in spans], dim=1)
    comp = component_id.long()
    counts = torch.zeros(n_components, dtype=torch.float32,
                         device=params.device).index_add_(
        0, comp, torch.ones(n, dtype=torch.float32, device=params.device))
    sums = torch.zeros((n_components, flat.shape[1]), dtype=torch.float32,
                       device=params.device).index_add_(0, comp, flat)
    means = sums / counts.clamp(min=1.0)[:, None]
    own = means[comp]
    within = torch.sqrt(((flat - own) ** 2).sum(dim=1)).mean()
    present = counts > 0
    d2 = ((means[:, None, :] - means[None, :, :]) ** 2).sum(-1)
    both = present[:, None] & present[None, :]
    gap = torch.sqrt(torch.where(both, d2, torch.zeros_like(d2)).max())
    return {
        "chaos_component_gap": gap,
        "chaos_within_mean": within,
        "chaos_active_components": present.sum(dtype=torch.int32),
    }


def chaos_event_row(vals: dict) -> Optional[dict]:
    """The per-round ``update_chaos`` observer payload (JSON-able
    scalars) from one round's chaos values; None when ``vals`` carries
    none."""
    if not vals:
        return None
    row: dict = {}
    if "chaos_component_gap" in vals:
        row["component_gap"] = float(vals["chaos_component_gap"])
        row["within_mean"] = float(vals["chaos_within_mean"])
        row["active_components"] = int(vals["chaos_active_components"])
    if "failed_chaos" in vals:
        row["failed_chaos"] = int(vals["failed_chaos"])
    return row or None


# ---------------------------------------------------------------------------
# Host-side recovery analysis
# ---------------------------------------------------------------------------

def rounds_to_reconverge(gap: np.ndarray, heal_round: int,
                         tol: Optional[float] = None) -> Optional[int]:
    """How many rounds after ``heal_round`` the per-round ``gap`` series
    (e.g. a report's ``chaos_component_gap``, index = round) took to
    close. ``tol`` defaults to 5% of the gap's peak over the pre-heal
    window (floor 1e-6). Returns the 1-based round count after the heal
    (0 = already closed at the heal round), or None if the series never
    closes within the report."""
    gap = np.asarray(gap, dtype=np.float64)
    heal = int(heal_round)
    if tol is None:
        peak = float(np.nanmax(gap[:heal])) if heal > 0 else 0.0
        tol = max(0.05 * peak, 1e-6)
    for i in range(heal, len(gap)):
        if np.isfinite(gap[i]) and gap[i] <= tol:
            return i - heal
    return None
