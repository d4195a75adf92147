"""Program gate: the round's op trace across the feature grid.

Twin of ``scripts/hlo_gate.py``, over the port's program (the op trace
of ``n_rounds`` rounds of ``start``; ``gossipy_tpu_torch.analysis.
program`` supplies the matrix and the helpers):

1. **Launch gate**: kernel entries per round executed, for the unfused,
   fused multi and fused compact delivers, against the JAX gate's counts
   through ``program.LAUNCH_MAP`` (unfused 0; multi 1; compact 1 here,
   2 in the JAX program, whose ``lax.cond`` holds both branches). On the
   card each entry is one launch: ``LAUNCHES`` must equal the
   kernel-entry log (``ENTRIES``) for every kernel.
2. **Identity pairs**: ``probes=None`` / ``sentinels=None`` /
   ``chaos=None`` / ``cohort=None`` / ``fused_merge=False`` (engine and
   All2All), and ``perf`` / ``metrics`` / ``tracing`` / ``ledger`` ON,
   must run the identical op sequence as a build without them. Enforced
   on any torch version and device; on a mismatch the case and the FIRST
   divergent op are printed and written to the ``--report`` JSON.
3. **Golden fingerprints**: every grid case is hashed and compared with
   ``gossipy_tpu_torch/analysis/program_golden.json`` where the golden
   has an entry for this process's torch version and device type;
   otherwise the fingerprints are logged and not compared. Record an
   entry with ``--update-golden`` after a deliberate program change or a
   torch upgrade.

Exit codes: 0 every gate green (or the comparison skipped with a
warning), 1 a divergence or a launch-count miss, 2 usage.

    python3 -m gossipy_tpu_torch.examples.program_gate --device cpu
    python3 -m gossipy_tpu_torch.examples.program_gate        # on the card
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import warnings
from pathlib import Path

import torch

from gossipy_tpu_torch import resolve_device
from gossipy_tpu_torch.analysis import program

GOLDEN = Path(program.__file__).parent / "program_golden.json"


def golden_key(device: torch.device) -> str:
    """The golden's key for this process: torch version and device type."""
    return f"{torch.__version__}|{device.type}"


def _log(msg: str) -> None:
    print(f"[program_gate] {msg}", flush=True)


def run_launch_gate(dev, n_rounds: int, report: dict) -> list:
    """The launch gate and, on the card, LAUNCHES == ENTRIES."""
    failures = []
    for name, build, want in program.gate_cases(dev)["launch"]:
        sim = build()
        state = program._fresh_state(sim)
        before = program.count_snapshot()
        got = program.kernel_launch_count(sim, n_rounds, state)
        launches, entries = program.count_delta(before)
        row = {"want": want, "got": got, "entries": entries,
               "jax": program.LAUNCH_MAP[name][0]}
        if dev.type == "cuda":
            row["launches"] = launches
            bad = program.launch_mismatches(before)
            if bad:
                failures.append(f"launch:{name}")
                _log(f"launch {name}: LAUNCHES != ENTRIES {bad}")
        report["launch"][name] = row
        if got == want:
            _log(f"launch {name}: {got:g} a round (JAX program "
                 f"{row['jax']}) OK; entries {entries}")
        else:
            failures.append(f"launch:{name}")
            _log(f"launch {name}: {got:g} a round != {want}: the fused "
                 "deliver must drain the whole mailbox in one kernel "
                 "launch a round")
    return failures


def run_identity(dev, n_rounds: int, report: dict) -> list:
    failures = []
    for name, build_a, build_b in program.gate_cases(dev)["identity"]:
        ta = program.program_text(build_a(), None, n_rounds)
        tb = program.program_text(build_b(), None, n_rounds)
        div = program.first_divergence(ta, tb, "default", "option")
        report["identity"][name] = {"identical": div is None,
                                    "ops": len(ta.splitlines()),
                                    "divergence": div}
        if div is None:
            _log(f"identity {name}: OK ({len(ta.splitlines())} ops)")
        else:
            failures.append(f"identity:{name}")
            _log(f"identity {name}: DIVERGED at canonical op {div['op']}:\n"
                 f"    default: {div['default']}\n"
                 f"    option:  {div['option']}")
    return failures


def run_fingerprints(dev, n_rounds: int, golden_path: Path, update: bool,
                     report: dict) -> list:
    failures = []
    prints = {}
    for name, build in program.gate_cases(dev)["fingerprint"]:
        fp, _ = program.program_fingerprint(build(), None, n_rounds)
        prints[name] = fp
        _log(f"fingerprint {name}: {fp}")
    report["fingerprint"] = prints
    key = golden_key(dev)
    golden = (json.loads(golden_path.read_text()) if golden_path.exists()
              else {"n_rounds": n_rounds, "golden": {}})
    if update:
        golden["n_rounds"] = n_rounds
        golden.setdefault("golden", {})[key] = prints
        golden_path.write_text(json.dumps(golden, indent=2, sort_keys=True)
                               + "\n")
        _log(f"golden entry {key} written -> {golden_path}")
        return failures
    want = golden.get("golden", {}).get(key)
    if want is None or golden.get("n_rounds") != n_rounds:
        report["golden_skipped"] = True
        _log(f"WARNING: the golden has no entry for {key} at {n_rounds} "
             "rounds: fingerprints logged, not compared (an op trace is "
             "not stable across torch releases or devices; the identity "
             "pairs still gate). Record one with --update-golden.")
        return failures
    for name, fp in prints.items():
        if name not in want:
            _log(f"WARNING: case {name} not in the golden entry (new "
                 "case?): add it with --update-golden")
        elif want[name] != fp:
            failures.append(f"fingerprint:{name}")
            _log(f"fingerprint {name}: CHANGED {want[name]} -> {fp}. If "
                 "deliberate, record it with --update-golden; otherwise a "
                 "change moved this program's ops.")
    stale = set(want) - set(prints)
    if stale:
        _log(f"WARNING: the golden entry has stale cases {sorted(stale)}")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--update-golden", action="store_true",
                    help="record this process's fingerprints as the "
                         "golden entry of its torch version and device")
    ap.add_argument("--golden", default=str(GOLDEN))
    ap.add_argument("--report", default=None,
                    help="write a JSON divergence/summary report here")
    ap.add_argument("--n-rounds", type=int, default=2)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    warnings.filterwarnings("ignore", message=r".*may overflow.*")

    t0 = time.perf_counter()
    report: dict = {"torch": torch.__version__, "device": dev.type,
                    "identity": {}, "fingerprint": {}, "launch": {},
                    "failures": []}
    cases = program.gate_cases(dev)
    _log(f"torch {torch.__version__} on {dev.type}; "
         f"{len(cases['identity'])} identity pairs, "
         f"{len(cases['fingerprint'])} fingerprint cases, "
         f"{len(cases['launch'])} launch-count cases")
    failures = run_launch_gate(dev, args.n_rounds, report)
    failures += run_identity(dev, args.n_rounds, report)
    failures += run_fingerprints(dev, args.n_rounds, Path(args.golden),
                                 args.update_golden, report)
    report["failures"] = failures
    report["elapsed_seconds"] = time.perf_counter() - t0
    if args.report:
        Path(args.report).write_text(json.dumps(report, indent=2) + "\n")
    _log(f"{'FAILED ' + ', '.join(failures) if failures else 'PASSED'} in "
         f"{report['elapsed_seconds']:.1f} s")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
