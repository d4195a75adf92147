"""Numerics sentinels: per-round numerical-health vitals.

Counterpart of the sentinels of ``gossipy_tpu/telemetry/health.py``
(``GossipSimulator(sentinels=True | SentinelConfig)``), over the port's
flat ``[N, stride]`` parameter rows. Every count and norm reads the leaf
columns only (the spans of :mod:`gossipy_tpu_torch.telemetry.probes`),
never the row's padding, and never the history ring:

- non-finite counts on the params and on the round's param delta, per
  leaf, plus non-finite entries in the round's evaluated metric rows;
- per-node divergence flags (a node whose param L2 norm exceeds a
  multiple of its own EMA) and the population-max norm;
- the round-delta norm with its running high-water mark, and the
  run-level mailbox-saturation watermark;
- a per-round ``health_trip`` flag: a non-finite count or a divergence
  flag fired this round.

The flight recorder and the bundle replay of the JAX module are not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from .probes import Spans, leaf_columns


@dataclass(frozen=True)
class SentinelConfig:
    """Which numerical-health sentinels a simulator computes per round.

    - ``nonfinite``: per-leaf non-finite counts on params / round delta /
      evaluated metrics, and the first mailbox slot whose delivery
      introduced a non-finite value.
    - ``divergence``: per-node param-norm-vs-own-EMA divergence flags.
    - ``saturation``: run-level mailbox occupancy watermark.
    - ``ema_alpha``: EMA coefficient for the per-node norm tracker.
    - ``divergence_factor``: a node trips when its param norm exceeds
      ``divergence_factor * max(ema, norm_floor)``.
    - ``norm_floor``: keeps near-zero EMAs (fresh zero-init models) from
      tripping on the first real update.
    """

    nonfinite: bool = True
    divergence: bool = True
    saturation: bool = True
    ema_alpha: float = 0.1
    divergence_factor: float = 10.0
    norm_floor: float = 1e-6

    def __post_init__(self):
        if not 0.0 < self.ema_alpha <= 1.0:
            raise ValueError("ema_alpha must be in (0, 1]")
        if self.divergence_factor <= 1.0:
            raise ValueError("divergence_factor must be > 1 (a node is "
                             "flagged when its norm EXCEEDS the EMA by "
                             "this factor)")

    @classmethod
    def coerce(cls, sentinels: Union[None, bool, "SentinelConfig"]
               ) -> Optional["SentinelConfig"]:
        """Normalize the ``sentinels=`` constructor argument:
        ``None``/``False`` → off (None), ``True`` → all sentinels at
        defaults, a :class:`SentinelConfig` → itself (None when every
        sentinel is off)."""
        if sentinels is None or sentinels is False:
            return None
        if sentinels is True:
            return cls()
        if isinstance(sentinels, cls):
            if not (sentinels.nonfinite or sentinels.divergence
                    or sentinels.saturation):
                return None
            return sentinels
        raise TypeError("sentinels= expects None, bool or SentinelConfig; "
                        f"got {type(sentinels).__name__}")

    def to_dict(self) -> dict:
        return {"nonfinite": self.nonfinite, "divergence": self.divergence,
                "saturation": self.saturation, "ema_alpha": self.ema_alpha,
                "divergence_factor": self.divergence_factor,
                "norm_floor": self.norm_floor}


class HealthCarry:
    """Cross-round sentinel state: the per-node norm EMA (``[N]``
    float32), the rounds folded into it (a host int), the high-water mark
    of the round-delta norm (float32) and the run-level mailbox watermark
    (int32). It survives from round to round and across ``start()``
    calls; ``init_nodes`` starts a fresh one."""

    __slots__ = ("norm_ema", "rounds_seen", "delta_hwm", "mailbox_hwm_run")

    def __init__(self, norm_ema, rounds_seen, delta_hwm, mailbox_hwm_run):
        self.norm_ema = norm_ema
        self.rounds_seen = rounds_seen
        self.delta_hwm = delta_hwm
        self.mailbox_hwm_run = mailbox_hwm_run

    @staticmethod
    def zeros(n: int, device) -> "HealthCarry":
        return HealthCarry(
            torch.zeros(n, dtype=torch.float32, device=device), 0,
            torch.zeros((), dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def nonfinite_counts(params: torch.Tensor, spans: Spans) -> torch.Tensor:
    """``[L]`` int32: non-finite scalar count per leaf of the rows."""
    return torch.stack([(~torch.isfinite(x)).sum(dtype=torch.int32)
                        for x in leaf_columns(params, spans)])


def nonfinite_total(params: torch.Tensor, spans: Spans) -> torch.Tensor:
    """0-d int32: total non-finite count over every leaf of the rows."""
    return nonfinite_counts(params, spans).sum(dtype=torch.int32)


def per_node_param_norm(params: torch.Tensor, spans: Spans) -> torch.Tensor:
    """``[N]`` float32: each node's param L2 norm over its leaves."""
    total = torch.zeros(params.shape[0], dtype=torch.float32,
                        device=params.device)
    for x in leaf_columns(params, spans):
        total = total + (x * x).sum(dim=1)
    return torch.sqrt(total)


# Per-round health stat keys the engine emits (and the report/event layers
# consume), in the JAX package's order. ``health_first_bad_slot`` comes
# from the mailbox slot loop; ``health_mix_nonfinite`` from All2All only.
HEALTH_STAT_KEYS = (
    "health_nonfinite_params",
    "health_nonfinite_delta",
    "health_nonfinite_metrics",
    "health_first_bad_slot",
    "health_mix_nonfinite",
    "health_diverged_per_node",
    "health_param_norm_max",
    "health_delta_norm",
    "health_delta_hwm",
    "health_mailbox_hwm_run",
    "health_trip",
)


def health_round_stats(cfg: SentinelConfig, hc: HealthCarry,
                       pre_params: torch.Tensor, params: torch.Tensor,
                       local_metrics: Optional[torch.Tensor],
                       global_metrics: Optional[torch.Tensor],
                       spans: Spans,
                       mailbox_hwm: Optional[torch.Tensor] = None,
                       ) -> tuple[HealthCarry, dict]:
    """One round's sentinel vitals.

    ``pre_params``/``params`` are the round-start (a copy taken before the
    round) and round-end rows; ``local_metrics``/``global_metrics`` the
    round's metric vectors (an all-NaN row means evaluation was skipped
    this round, ``eval_every``, and counts zero). Returns the advanced
    carry and the round's ``health_*`` stats entries.
    """
    out: dict = {}
    dev = params.device
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    nf_any = torch.zeros((), dtype=torch.bool, device=dev)
    div_any = nf_any
    delta = params.to(torch.float32) - pre_params.to(torch.float32)
    if cfg.nonfinite:
        nf_p = nonfinite_counts(params, spans)
        nf_d = nonfinite_counts(delta, spans)
        out["health_nonfinite_params"] = nf_p
        out["health_nonfinite_delta"] = nf_d
        m = zero_i
        for v in (local_metrics, global_metrics):
            if v is None:
                continue
            ran = ~torch.isnan(v).all()
            m = m + torch.where(ran, (~torch.isfinite(v)).sum(
                dtype=torch.int32), zero_i)
        out["health_nonfinite_metrics"] = m
        nf_any = (nf_p.sum() + nf_d.sum() + m) > 0

    norms = per_node_param_norm(params, spans)
    if cfg.divergence:
        seeded = hc.rounds_seen > 0
        ema = hc.norm_ema if seeded else norms
        threshold = cfg.divergence_factor * ema.clamp(min=cfg.norm_floor)
        flags = ((norms > threshold) & seeded).to(torch.int32)
        # Non-finite norms stay out of the EMA (one NaN round must not
        # poison the baseline the healthy rounds are judged against).
        new_ema = torch.where(
            torch.isfinite(norms),
            (1.0 - cfg.ema_alpha) * ema + cfg.ema_alpha * norms, ema)
        hc = HealthCarry(new_ema, hc.rounds_seen, hc.delta_hwm,
                         hc.mailbox_hwm_run)
        out["health_diverged_per_node"] = flags
        out["health_param_norm_max"] = norms.max()
        div_any = flags.sum() > 0

    delta_sq = torch.zeros((), dtype=torch.float32, device=dev)
    for d in leaf_columns(delta, spans):
        delta_sq = delta_sq + (d * d).sum()
    delta_norm = torch.sqrt(delta_sq)
    new_hwm = torch.where(torch.isfinite(delta_norm),
                          torch.maximum(hc.delta_hwm, delta_norm),
                          hc.delta_hwm)
    out["health_delta_norm"] = delta_norm
    out["health_delta_hwm"] = new_hwm
    hc = HealthCarry(hc.norm_ema, hc.rounds_seen + 1, new_hwm,
                     hc.mailbox_hwm_run)

    if cfg.saturation and mailbox_hwm is not None:
        run_hwm = torch.maximum(hc.mailbox_hwm_run,
                                torch.as_tensor(mailbox_hwm, device=dev)
                                .to(torch.int32))
        hc = HealthCarry(hc.norm_ema, hc.rounds_seen, hc.delta_hwm, run_hwm)
        out["health_mailbox_hwm_run"] = run_hwm

    out["health_trip"] = (nf_any | div_any).to(torch.int32)
    return hc, out


def health_event_row(vals: dict) -> Optional[dict]:
    """The per-round ``update_health`` observer payload (JSON-able
    scalars) from one round's health values — keys for disabled
    sentinels are simply absent. Returns None when ``vals`` carries no
    health stat at all."""
    if not vals:
        return None
    row: dict = {}
    if "health_nonfinite_params" in vals:
        row["nonfinite_params"] = int(
            np.asarray(vals["health_nonfinite_params"]).sum())
        row["nonfinite_delta"] = int(
            np.asarray(vals["health_nonfinite_delta"]).sum())
        row["nonfinite_metrics"] = int(vals["health_nonfinite_metrics"])
    if "health_first_bad_slot" in vals:
        row["first_bad_slot"] = int(vals["health_first_bad_slot"])
    if "health_mix_nonfinite" in vals:
        row["mix_nonfinite"] = int(vals["health_mix_nonfinite"])
    if "health_diverged_per_node" in vals:
        row["diverged"] = int(
            np.asarray(vals["health_diverged_per_node"]).sum())
        row["param_norm_max"] = float(vals["health_param_norm_max"])
    if "health_delta_norm" in vals:
        row["delta_norm"] = float(vals["health_delta_norm"])
        row["delta_hwm"] = float(vals["health_delta_hwm"])
    if "health_mailbox_hwm_run" in vals:
        row["mailbox_hwm_run"] = int(vals["health_mailbox_hwm_run"])
    if "health_trip" in vals:
        row["trip"] = bool(int(vals["health_trip"]))
    return row or None
