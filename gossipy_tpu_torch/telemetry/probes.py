"""Gossip-dynamics probes: consensus, staleness and mixing health.

Counterpart of ``gossipy_tpu/telemetry/probes.py``, over the port's flat
``[N, stride]`` parameter rows: a leaf is the column span
``(offset, size)`` the handler's :class:`~gossipy_tpu_torch.models.nn.
ParamLayout` gives it, in the JAX package's ``tree_leaves`` order, and the
row's padding columns are never read.

- **consensus distance**: per-round mean/max L2 distance of each node's
  params from the population mean, plus a per-leaf breakdown;
- **merge staleness**: the distribution of ``current_round - send_round``
  over accepted model-carrying messages (mean/max plus a clamped
  histogram whose sum equals the round's accepted-message count);
- **realized mixing**: per-node accepted-merge counts and the per-round
  merge-delta vs train-delta norms.

Probes are opt-in (``GossipSimulator(probes=...)``): with ``probes=None``
the round computes none of this. On a mesh across ranks the engine folds
the whole population's slot tables and rows (gathered) into one
accumulator and computes :func:`consensus_stats` over every node's
rows, so every rank reports the values one process reports.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np
import torch

Spans = Sequence[tuple]   # [(offset, size)] per leaf, in leaf order


@dataclass(frozen=True)
class ProbeConfig:
    """Which gossip-dynamics probes a simulator computes per round.

    - ``consensus``: mean/max L2 distance from the population-mean params
      plus the per-layer breakdown.
    - ``staleness``: mean/max + bucketed histogram of
      ``current_round − send_round`` over accepted messages.
    - ``mixing``: per-node accepted-merge counts and the merge-delta vs
      train-delta norm decomposition.
    - ``staleness_buckets``: histogram length; staleness values at or
      beyond the last bucket are clamped into it.
    """

    consensus: bool = True
    staleness: bool = True
    mixing: bool = True
    staleness_buckets: int = 8

    def __post_init__(self):
        if self.staleness_buckets < 2:
            raise ValueError("staleness_buckets must be >= 2 (bucket 0 "
                             "holds same-round merges; the last bucket "
                             "clamps the tail)")

    @classmethod
    def coerce(cls, probes: Union[None, bool, "ProbeConfig"]
               ) -> Optional["ProbeConfig"]:
        """Normalize the ``probes=`` constructor argument: ``None``/``False``
        → off (None), ``True`` → all probes at defaults, a
        :class:`ProbeConfig` → itself (None when every probe is off)."""
        if probes is None or probes is False:
            return None
        if probes is True:
            return cls()
        if isinstance(probes, cls):
            if not (probes.consensus or probes.staleness or probes.mixing):
                return None
            return probes
        raise TypeError("probes= expects None, bool or ProbeConfig; got "
                        f"{type(probes).__name__}")

    def to_dict(self) -> dict:
        return {"consensus": self.consensus, "staleness": self.staleness,
                "mixing": self.mixing,
                "staleness_buckets": self.staleness_buckets}


class ProbeAccum:
    """One round's probe accumulator, folded slot by slot through the
    deliver and reply phases (summed across them). Device tensors:

    - ``accepted`` ``[N]`` int32: accepted model-carrying merges;
    - ``stale_sum``, ``stale_max`` int32: staleness over them;
    - ``stale_hist`` ``[B]`` int32: the clamped staleness histogram;
    - ``merge_sq``, ``train_sq`` float32: squared merge- and train-delta
      norms.
    """

    __slots__ = ("accepted", "stale_sum", "stale_max", "stale_hist",
                 "merge_sq", "train_sq")

    def __init__(self, accepted, stale_sum, stale_max, stale_hist, merge_sq,
                 train_sq):
        self.accepted = accepted
        self.stale_sum = stale_sum
        self.stale_max = stale_max
        self.stale_hist = stale_hist
        self.merge_sq = merge_sq
        self.train_sq = train_sq

    @staticmethod
    def zeros(n: int, buckets: int, device) -> "ProbeAccum":
        i32 = dict(dtype=torch.int32, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        return ProbeAccum(torch.zeros(n, **i32), torch.zeros((), **i32),
                          torch.zeros((), **i32), torch.zeros(buckets, **i32),
                          torch.zeros((), **f32), torch.zeros((), **f32))

    def __add__(self, other: "ProbeAccum") -> "ProbeAccum":
        return ProbeAccum(self.accepted + other.accepted,
                          self.stale_sum + other.stale_sum,
                          torch.maximum(self.stale_max, other.stale_max),
                          self.stale_hist + other.stale_hist,
                          self.merge_sq + other.merge_sq,
                          self.train_sq + other.train_sq)

    def record_slot(self, accepted_mask: torch.Tensor,
                    staleness: torch.Tensor) -> "ProbeAccum":
        """Fold one mailbox slot's accepted messages in: ``accepted_mask``
        ``[N]`` bool, ``staleness`` ``[N]`` (rounds since the payload
        snapshot; read only where the mask holds), or ``[N, K]`` for every
        slot of a cell at once (the sums and the max do not depend on the
        slot order). Each accepted message adds 1 to ``accepted[receiver]``
        and to one histogram bucket, so ``stale_hist.sum() ==
        accepted.sum()``."""
        acc = accepted_mask.to(torch.int32)
        stale = torch.where(accepted_mask, staleness.to(torch.int32),
                            torch.zeros_like(acc))
        bucket = stale.clamp(0, self.stale_hist.shape[0] - 1).long()
        per_node = acc if acc.dim() == 1 else acc.sum(dim=1,
                                                      dtype=torch.int32)
        return ProbeAccum(self.accepted + per_node,
                          self.stale_sum + stale.sum(dtype=torch.int32),
                          torch.maximum(self.stale_max, stale.max()),
                          self.stale_hist.index_add(0, bucket.reshape(-1),
                                                    acc.reshape(-1)),
                          self.merge_sq, self.train_sq)

    def add_deltas(self, merge_sq, train_sq) -> "ProbeAccum":
        return ProbeAccum(self.accepted, self.stale_sum, self.stale_max,
                          self.stale_hist, self.merge_sq + merge_sq,
                          self.train_sq + train_sq)


def leaf_columns(params: torch.Tensor, spans: Spans) -> list:
    """The ``[N, size]`` column block of each leaf, as float32."""
    return [params[:, o:o + w].to(torch.float32) for o, w in spans]


def sq_param_distance(a: torch.Tensor, b: torch.Tensor,
                      spans: Spans) -> torch.Tensor:
    """0-d float32: total squared L2 distance between two stacks of rows
    over the leaf columns, summed leaf by leaf."""
    total = torch.zeros((), dtype=torch.float32, device=a.device)
    for la, lb in zip(leaf_columns(a, spans), leaf_columns(b, spans)):
        d = la - lb
        total = total + (d * d).sum()
    return total


def consensus_stats(params: torch.Tensor, spans: Spans):
    """Consensus-distance statistics over ``[N, stride]`` rows: ``(mean,
    max, per_layer)``, the mean/max over nodes of each node's L2 distance
    from the population-mean row (every leaf), and ``[L]`` float32 the
    mean over nodes of the per-leaf distance, in leaf order (names by
    :func:`param_layer_names`)."""
    per_leaf_sq = []
    for x in leaf_columns(params, spans):
        d = x - x.mean(dim=0, keepdim=True)
        per_leaf_sq.append((d * d).sum(dim=1))
    total_sq = per_leaf_sq[0]
    for s in per_leaf_sq[1:]:
        total_sq = total_sq + s
    dist = torch.sqrt(total_sq)
    per_layer = torch.stack([torch.sqrt(s).mean() for s in per_leaf_sq])
    return dist.mean(), dist.max(), per_layer


def param_layer_names(layout) -> list[str]:
    """Leaf names matching :func:`consensus_stats`'s ``per_layer`` order,
    as the JAX package names its pytree paths (``"Dense_0/kernel"``; a
    bare array is ``"param"``)."""
    return [name or "param" for name, _ in layout.leaves]


# Per-round probe stat keys the engine emits (and the report/event layers
# consume), grouped by the ProbeConfig flag that enables them.
CONSENSUS_KEYS = ("probe_consensus_mean", "probe_consensus_max",
                  "probe_consensus_per_layer")
STALENESS_KEYS = ("probe_stale_mean", "probe_stale_max", "probe_stale_hist")
MIXING_KEYS = ("probe_accepted_per_node", "probe_merge_delta",
               "probe_train_delta")
PROBE_STAT_KEYS = CONSENSUS_KEYS + STALENESS_KEYS + MIXING_KEYS


def probe_stats_from_accum(cfg: ProbeConfig, pa: ProbeAccum,
                           delta_ok: bool) -> dict:
    """The staleness/mixing entries of a round's stats dict from the
    accumulated :class:`ProbeAccum`. ``delta_ok`` says the merge/train
    decomposition is exact for this simulator's receive path (the base
    pipeline under MERGE_UPDATE); when False the delta columns are NaN."""
    out: dict = {}
    if cfg.staleness:
        count = pa.stale_hist.sum()
        out["probe_stale_mean"] = torch.where(
            count > 0,
            pa.stale_sum.to(torch.float32)
            / count.clamp(min=1).to(torch.float32),
            torch.zeros((), dtype=torch.float32, device=count.device))
        out["probe_stale_max"] = pa.stale_max
        out["probe_stale_hist"] = pa.stale_hist
    if cfg.mixing:
        out["probe_accepted_per_node"] = pa.accepted
        if delta_ok:
            out["probe_merge_delta"] = torch.sqrt(pa.merge_sq)
            out["probe_train_delta"] = torch.sqrt(pa.train_sq)
        else:
            nan = torch.full((), float("nan"), device=pa.merge_sq.device)
            out["probe_merge_delta"] = nan
            out["probe_train_delta"] = nan
    return out


def probe_event_row(vals: dict) -> Optional[dict]:
    """The per-round ``update_probes`` observer payload (JSON-able scalars
    + the histogram) from one round's probe values. ``vals`` maps the
    ``probe_*`` stat keys to host scalars/arrays for ONE round; keys for
    disabled probes are simply absent. Returns None when ``vals`` carries
    no probe at all."""
    if not vals:
        return None
    row: dict = {}
    if "probe_consensus_mean" in vals:
        row["consensus_mean"] = float(vals["probe_consensus_mean"])
        row["consensus_max"] = float(vals["probe_consensus_max"])
    if "probe_stale_mean" in vals:
        row["stale_mean"] = float(vals["probe_stale_mean"])
        row["stale_max"] = int(vals["probe_stale_max"])
        row["stale_hist"] = [int(v) for v in
                             np.asarray(vals["probe_stale_hist"])]
    if "probe_accepted_per_node" in vals:
        row["accepted_total"] = int(
            np.asarray(vals["probe_accepted_per_node"]).sum())
        md = float(vals["probe_merge_delta"])
        td = float(vals["probe_train_delta"])
        row["merge_delta"] = None if np.isnan(md) else md
        row["train_delta"] = None if np.isnan(td) else td
    return row or None
