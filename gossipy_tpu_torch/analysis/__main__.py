"""``python -m gossipy_tpu_torch.analysis``: run tracelint over the port.

Exit status: 0 when every finding is suppressed or baselined (the
baseline is the inventory of the round's host syncs), 1 when NEW findings
exist, 2 on usage errors.

Typical invocations::

    python -m gossipy_tpu_torch.analysis                  # fail on new
    python -m gossipy_tpu_torch.analysis --json out.json  # + JSON
    python -m gossipy_tpu_torch.analysis --write-baseline # accept the tree
    python -m gossipy_tpu_torch.analysis --all            # no baseline
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .tracelint import (
    baseline_from_findings,
    filter_baselined,
    load_baseline,
    run_tracelint,
)

_DEFAULT_BASELINE = Path(__file__).parent / "baseline.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gossipy_tpu_torch.analysis",
                                 description=__doc__)
    ap.add_argument("--root", default=None,
                    help="repo root containing the gossipy_tpu_torch "
                         "package "
                         "(default: auto-detected from the installed "
                         "package location)")
    ap.add_argument("--baseline", default=str(_DEFAULT_BASELINE),
                    help="baseline JSON waiving pre-existing findings")
    ap.add_argument("--all", action="store_true",
                    help="report every finding, ignoring the baseline")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="write the findings (all + new) as JSON")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline to accept the current tree")
    args = ap.parse_args(argv)

    root = Path(args.root) if args.root else Path(__file__).parents[2]
    if not (root / "gossipy_tpu_torch").is_dir():
        print(f"tracelint: no gossipy_tpu_torch package under {root}",
              file=sys.stderr)
        return 2

    findings = run_tracelint(root)
    baseline = load_baseline(args.baseline)
    new = findings if args.all else filter_baselined(findings, baseline)

    if args.write_baseline:
        Path(args.baseline).write_text(
            json.dumps(baseline_from_findings(findings), indent=2,
                       sort_keys=True) + "\n")
        print(f"tracelint: baseline rewritten with {len(findings)} "
              f"finding(s) -> {args.baseline}")
        return 0

    if args.json_out:
        Path(args.json_out).write_text(json.dumps({
            "total": len(findings),
            "new": [f.to_dict() for f in new],
            "all": [f.to_dict() for f in findings],
        }, indent=2) + "\n")

    for f in new:
        print(f)
        print(f"    {f.snippet}")
    waived = len(findings) - len(new)
    print(f"tracelint: {len(findings)} finding(s), {waived} baselined, "
          f"{len(new)} new")
    if new:
        print("tracelint: fix the new finding(s), suppress with "
              "`# tracelint: disable=<rule>`, or re-baseline with "
              "--write-baseline (reviewed changes only)")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
