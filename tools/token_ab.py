"""The token north star's ms/round on K3 and K4 through the code of each
tree named, each tree in a process of its own, in the order given. Not
part of the smoke run. From the repo root, on a host with a card, with an
earlier commit unpacked into a directory::

    mkdir -p _archive/parent
    git archive <commit> | tar -x -C _archive/parent
    python3 tools/token_ab.py _archive/parent . . _archive/parent \\
        [--out FILE]

Each run is the tree's own ``chip_smoke.variant_timed`` of
``tokenized-float32`` (K3, a float32 ring) and ``tokenized-bfloat16``
(K4, a bfloat16 ring): 100 nodes at full width, a warm-up round, then
100 timed rounds on the host's clock, the card synchronised, and one
profiled round's idle share. Prints each run's ``[variants]`` line and
one JSON object of them all (also written to ``--out``), then the card's
name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys

LABELS = ("tokenized-float32", "tokenized-bfloat16")


def one(tree: str) -> None:
    """In this process: the runs through ``tree``'s code, one JSON line."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import chip_smoke as cs
    from gossipy_tpu_torch.ops import merge
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sets = cs.variant_sets()
    out = {}
    for label in LABELS:
        run = cs.variant_timed(torch, merge, label, sets)
        out[label] = {k: run[k] for k in ("ms_per_round", "idle_share",
                                          "launches", "accuracy")}
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="*",
                        help="repo trees, each run in turn")
    parser.add_argument("--one", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--out", default=None,
                        help="also write the JSON object to this file")
    opts = parser.parse_args()
    if opts.one:
        one(opts.one)
        return 0
    import torch
    if not torch.cuda.is_available() or not opts.trees:
        print("token_ab: no CUDA device or no tree", file=sys.stderr)
        return 2
    runs = []
    for tree in opts.trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", os.path.abspath(tree)],
                              cwd=tree,
                              capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            if line.startswith("[variants] tokenized"):
                print(f"[token_ab] {tree}: {line}", flush=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        runs.append({"tree": tree,
                     **json.loads(proc.stdout.strip().splitlines()[-1])})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    report = {"card": smi, "runs": runs}
    if opts.out:
        with open(opts.out, "w") as fh:
            json.dump(report, fh, indent=1)
    print(json.dumps(report), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
