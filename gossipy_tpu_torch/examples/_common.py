"""Command-line plumbing shared by the paper-example twins.

Counterpart of ``examples/_common.py``: the same ``--rounds``,
``--nodes``, ``--plot`` and ``--seed`` flags, ``--repetitions`` where a
script honours it, plus ``--device`` (``cuda`` unless ``cpu`` is given);
:func:`finish` prints the one-line JSON summary.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from ..utils import plot_evaluation


def make_parser(description: str, rounds: int, nodes: Optional[int] = None
                ) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=rounds,
                   help=f"simulation rounds (reference config: {rounds})")
    if nodes is not None:
        p.add_argument("--nodes", type=int, default=nodes,
                       help=f"number of gossip nodes (reference config: "
                            f"{nodes or 'one per sample'})")
    p.add_argument("--plot", type=str, default=None,
                   help="save metric curves to this path (PNG)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def add_repetitions_flag(p: argparse.ArgumentParser):
    p.add_argument("--repetitions", type=int, default=1,
                   help="independent repetitions, run one after another")
    return p


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
    print(json.dumps(summary), flush=True)
    if args.plot:
        plot_evaluation([[ev for _, ev in e] for e in evals_per_rep if e],
                        title=sys.argv[0], path=args.plot)
    return summary
