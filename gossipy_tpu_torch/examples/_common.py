"""Command-line plumbing shared by the paper-example twins.

Counterpart of ``examples/_common.py``: the same ``--rounds``,
``--nodes``, ``--plot`` and ``--seed`` flags, ``--repetitions``,
``--probes``, ``--sentinels`` and ``--chaos`` where a script honours
them, plus ``--device`` (``cuda`` unless ``cpu`` is given); :func:`finish`
prints the one-line JSON summary, with the probe, sentinel and chaos
summary of a run that computed them (:func:`telemetry_summary`).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np

from ..simulation.faults import ChaosConfig, PartitionEpisode, \
    rounds_to_reconverge
from ..utils import plot_evaluation


def make_parser(description: str, rounds: int, nodes: Optional[int] = None,
                with_plot: bool = True) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=rounds,
                   help=f"simulation rounds (reference config: {rounds})")
    if nodes is not None:
        p.add_argument("--nodes", type=int, default=nodes,
                       help=f"number of gossip nodes (reference config: "
                            f"{nodes or 'one per sample'})")
    if with_plot:
        p.add_argument("--plot", type=str, default=None,
                       help="save metric curves to this path (PNG)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def add_repetitions_flag(p: argparse.ArgumentParser):
    p.add_argument("--repetitions", type=int, default=1,
                   help="independent repetitions, run one after another")
    return p


def add_probes_flag(p: argparse.ArgumentParser):
    p.add_argument("--probes", action="store_true",
                   help="compute the gossip-dynamics probes (consensus "
                        "distance, merge staleness, realized mixing) and "
                        "print their summary")
    return p


def add_sentinels_flag(p: argparse.ArgumentParser):
    p.add_argument("--sentinels", action="store_true",
                   help="compute the numerics sentinels (non-finite counts, "
                        "divergence flags, saturation watermarks) and print "
                        "their summary")
    return p


def add_chaos_flag(p: argparse.ArgumentParser):
    p.add_argument("--chaos", action="store_true",
                   help="inject the demo fault scenario: the population "
                        "partitioned in half for the middle third of the "
                        "run, then healed; with --probes the summary names "
                        "the partition's consensus gap and the rounds it "
                        "took to reconverge")
    return p


def demo_chaos_config(args) -> Optional[ChaosConfig]:
    """The ``--chaos`` scenario: a half/half partition over the middle
    third of the run (the heal round is kept on ``args`` for
    :func:`finish`). None when the flag is off."""
    if not getattr(args, "chaos", False):
        return None
    n, r = args.nodes, args.rounds
    a = max(r // 3, 1)
    b = max(2 * r // 3, a + 1)
    args._chaos_heal = b
    half = n // 2
    return ChaosConfig(partitions=(PartitionEpisode(
        components=(tuple(range(half)), tuple(range(half, n))),
        start=a, stop=b),), horizon=r)


def telemetry_summary(report, args) -> dict:
    """The ``probes``, ``health`` and ``chaos`` entries of the summary,
    each present when the run computed it, with the JAX scripts' keys."""
    out: dict = {}
    cm = report.probe_consensus_mean
    if cm is not None and len(cm):
        probes = {"consensus_first": round(float(cm[0]), 6),
                  "consensus_last": round(float(cm[-1]), 6)}
        sm = report.probe_stale_max
        if sm is not None and len(sm):
            probes["stale_max"] = int(np.max(sm))
        acc = report.probe_accepted_per_node
        if acc is not None:
            probes["accepted_total"] = int(np.sum(acc))
        md, td = report.probe_merge_delta, report.probe_train_delta
        if md is not None and len(md) and np.isfinite(md[-1]):
            probes["merge_delta_last"] = round(float(md[-1]), 6)
            probes["train_delta_last"] = round(float(td[-1]), 6)
        out["probes"] = probes
    trips = report.health_trip
    if trips is not None:
        health = {"trips": int(np.sum(trips))}
        nf = report.health_nonfinite_params
        if nf is not None:
            health["nonfinite_params"] = int(np.sum(nf))
        dv = report.health_diverged_per_node
        if dv is not None:
            health["diverged"] = int(np.sum(dv))
        hwm = report.health_delta_hwm
        if hwm is not None and len(hwm) and np.isfinite(hwm[-1]):
            health["delta_hwm"] = round(float(hwm[-1]), 6)
        out["health"] = health
    cause = report.failed_per_cause or {}
    gap = report.chaos_component_gap
    if "chaos" in cause or (gap is not None and len(gap)):
        chaos = {}
        if "chaos" in cause:
            chaos["failed_chaos"] = int(np.sum(cause["chaos"]))
        if gap is not None and len(gap):
            chaos["gap_peak"] = round(float(np.nanmax(gap)), 6)
            chaos["gap_last"] = round(float(gap[-1]), 6)
            heal = getattr(args, "_chaos_heal", None)
            if heal is not None and heal < len(gap):
                chaos["rounds_to_reconverge"] = rounds_to_reconverge(gap,
                                                                     heal)
        out["chaos"] = chaos
    return out


def finish(report, args, local: bool = False, label: str = "final") -> dict:
    """Print the one-line JSON summary of one report or of a list of them
    (one per repetition: the mean final metrics), and save the plot when
    ``--plot`` is given. Returns the summary."""
    reports = report if isinstance(report, (list, tuple)) else [report]
    evals_per_rep = [r.get_evaluation(local) for r in reports]
    evals = evals_per_rep[0]
    summary = {
        "rounds": len(evals),
        "repetitions": len(reports),
        "sent_messages": sum(r.sent_messages for r in reports),
        "failed_messages": sum(r.failed_messages for r in reports),
        "total_size": sum(r.total_size for r in reports),
    }
    if evals:
        finals = [e[-1][1] for e in evals_per_rep if e]
        summary[label] = {k: round(sum(f[k] for f in finals) / len(finals), 4)
                          for k in finals[0]}
    summary.update(telemetry_summary(reports[0], args))
    print(json.dumps(summary), flush=True)
    if args.plot:
        plot_evaluation([[ev for _, ev in e] for e in evals_per_rep if e],
                        title=sys.argv[0], path=args.plot)
    return summary
