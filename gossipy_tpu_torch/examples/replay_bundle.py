"""Replay a flight-recorder bundle and localize the first divergent op.

Twin of the JAX package's ``scripts/replay_bundle.py``. Restores a bundle
written by :class:`gossipy_tpu_torch.telemetry.FlightRecorder` (the last
healthy state, the draw state at its round and the trailing telemetry
window) into a freshly built simulator and replays it round by round:
the draws continue from the saved draw state, so the replay follows the
recorded run bit for bit on the same device. Prints a JSON verdict
naming:

- the first divergent round (``matches_recorded`` says whether it equals
  the recorded verdict's),
- the first non-finite parameter leaf and the affected node ids,
- the engine phase (send / receive_merge / reply) that introduced the
  first non-finite value, found by re-running the offending round phase
  by phase.

A bundle written on a mesh across ranks holds the whole population (its
checkpoint is the file one process writes), so it replays here in one
process, unsharded, and names the same first bad round.

The bundle carries state, not code: the caller names a FACTORY that
rebuilds the simulator with the recorded configuration (the bundle's
``manifest.json`` ``config`` block documents it):

    python3 -m gossipy_tpu_torch.examples.replay_bundle <bundle> \\
        --factory mymod:build_sim
    python3 -m gossipy_tpu_torch.examples.replay_bundle <bundle> --demo

The factory is an importable ``module:callable`` returning a
sentinel-enabled simulator; ``--demo`` rebuilds :func:`demo_sim`, the
simulator of :func:`record_demo` (``--record DIR`` writes its bundle).
Exit status: 0 when the replay verdict matches the recorded one (or the
bundle recorded no sentinel round: exception and watchdog bundles), 1
on a mismatch.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

import numpy as np

# The demo: a 16-node LogReg gossip run whose node POISON trains on NaN
# features, so its params turn non-finite the first round it trains.
DEMO_NODES = 16
DEMO_POISON = 3
DEMO_SEED = 42


def demo_sim(device=None, nodes: int = DEMO_NODES, poison=DEMO_POISON):
    """The demo's sentinel-enabled simulator: a linearly separable
    12-feature set, LogReg under SGD 0.1, batch 8, MERGE_UPDATE, PUSH on
    ``random_regular(nodes, 4, seed=42)``, ``delta=20``, the default
    (single-pass) deliver, draws from ``TorchDraws(42)``; node ``poison``'s
    training features are NaN (None: none are)."""
    from gossipy_tpu_torch.core import CreateModelMode, Topology
    from gossipy_tpu_torch.data import ClassificationDataHandler, \
        DataDispatcher
    from gossipy_tpu_torch.handlers import SGDHandler, losses
    from gossipy_tpu_torch.models import LogisticRegression
    from gossipy_tpu_torch.random import TorchDraws
    from gossipy_tpu_torch.simulation import GossipSimulator

    rng = np.random.default_rng(DEMO_SEED)
    d = 12
    X = rng.normal(size=(20 * nodes, d)).astype(np.float32)
    y = (X @ rng.normal(size=d) > 0).astype(np.int64)
    dh = ClassificationDataHandler(X, y, test_size=0.25, seed=DEMO_SEED)
    stacked = dict(DataDispatcher(dh, n=nodes, eval_on_user=False).stacked())
    if poison is not None:
        xtr = stacked["xtr"].copy()
        xtr[poison] = np.nan
        stacked["xtr"] = xtr
    handler = SGDHandler(LogisticRegression(d, 2), losses.cross_entropy,
                         learning_rate=0.1, local_epochs=1, batch_size=8,
                         n_classes=2, input_shape=(d,),
                         create_model_mode=CreateModelMode.MERGE_UPDATE)
    return GossipSimulator(handler, Topology.random_regular(nodes, 4,
                                                            seed=42),
                           stacked, delta=20, sentinels=True,
                           draws=TorchDraws(DEMO_SEED), device=device)


def record_demo(out_dir: str, device=None, rounds: int = 12,
                chunk: int = 4):
    """Run :func:`demo_sim` under a :class:`FlightRecorder` (``chunk``
    rounds a segment) from ``init_nodes(local_train=False)``; returns
    ``(bundle_path, reports)``."""
    import torch

    from gossipy_tpu_torch.telemetry import FlightRecorder
    sim = demo_sim(device)
    state = sim.init_nodes(torch.Generator().manual_seed(DEMO_SEED),
                           local_train=False)
    _, reports, bundle = FlightRecorder(out_dir, chunk=chunk).run(
        sim, state, rounds)
    return bundle, reports


def _load_factory(spec: str):
    mod_name, _, attr = spec.partition(":")
    if not attr:
        raise SystemExit(f"--factory expects module:callable, got {spec!r}")
    return getattr(importlib.import_module(mod_name), attr)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("bundle", nargs="?",
                    help="flight-recorder bundle directory")
    ap.add_argument("--factory", default=None,
                    help="module:callable returning the simulator the "
                         "bundle was recorded from (sentinels enabled)")
    ap.add_argument("--demo", action="store_true",
                    help="rebuild the demo simulator (demo_sim)")
    ap.add_argument("--record", default=None, metavar="DIR",
                    help="record the demo's bundle into DIR first, then "
                         "replay it (implies --demo)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--max-rounds", type=int, default=None,
                    help="replay at most this many rounds past the "
                         "checkpoint (default: up to the recorded "
                         "first-bad round, or 64)")
    ap.add_argument("--no-localize", action="store_true",
                    help="skip the per-phase localization pass")
    args = ap.parse_args(argv)
    if args.record is not None:
        args.demo = True
        args.bundle, _ = record_demo(args.record, args.device)
        if args.bundle is None:
            raise SystemExit("the demo run recorded no bundle")
    if args.bundle is None:
        ap.error("a bundle directory is required (or --record DIR)")
    if args.demo == (args.factory is not None):
        raise SystemExit("pass exactly one of --factory or --demo")

    from gossipy_tpu_torch.telemetry import replay_bundle

    if args.demo:
        sim = demo_sim(args.device)
    else:
        sim = _load_factory(args.factory)()

    with open(os.path.join(args.bundle, "verdict.json")) as fh:
        recorded = json.load(fh)
    print(f"[replay] bundle kind={recorded['kind']} "
          f"chunk_start_round={recorded['chunk_start_round']} "
          f"recorded first_bad_round={recorded['first_bad_round']}",
          file=sys.stderr)

    verdict = replay_bundle(args.bundle, sim, max_rounds=args.max_rounds,
                            localize=not args.no_localize)
    print(json.dumps(verdict, indent=2), flush=True)
    if verdict["matches_recorded"] is False:
        print("[replay] MISMATCH: the replayed first-divergent round "
              "differs from the recorded one: was the factory built with "
              "the recorded config (see the bundle's manifest.json) and "
              "run on the same device?", file=sys.stderr)
        sys.exit(1)
    return verdict


if __name__ == "__main__":
    main()
