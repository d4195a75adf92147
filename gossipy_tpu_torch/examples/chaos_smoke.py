"""Chaos smoke: partition, heal, prove reconvergence, with artifacts.

Twin of ``scripts/chaos_smoke.py``. A small chaos run (16 nodes on a
clique, LogReg SGD 0.2, batch 16, PUSH, consensus probes on) whose
population splits into two components at round 3 and heals at round 6,
14 rounds, then self-checks the recovery:

- the partition consensus gap (``chaos_component_gap``) is ~0 before
  the partition, OPENS while it holds, and closes after the heal (its
  post-heal minimum under a quarter of the partition's peak);
  ``simulation.rounds_to_reconverge`` names the rounds;
- the run is bit-identical when driven as two ``start()`` calls across
  the heal (5 + 9 rounds from a clone of the same initial state and the
  same draw state): the gap and the sends per round;
- the sequential engine agrees on the structural story (the gap open
  during the window, closed after) for the same configuration.

Writes into ``--out DIR``: ``report.json`` (the chaos run's report),
``chaos_verdict.json`` (the checks, the per-round gaps of both engines,
the rounds to reconverge) and ``events.jsonl`` (the per-round rows with
their ``chaos`` field). Exits 1 on any failed check.

    python3 -m gossipy_tpu_torch.examples.chaos_smoke --device cpu
    python3 -m gossipy_tpu_torch.examples.chaos_smoke --out chaos-artifacts
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from gossipy_tpu_torch import resolve_device, set_seed
from gossipy_tpu_torch.checkpoint import clone_state, draw_record
from gossipy_tpu_torch.core import AntiEntropyProtocol, CreateModelMode, \
    Topology
from gossipy_tpu_torch.data import ClassificationDataHandler, DataDispatcher
from gossipy_tpu_torch.handlers import SGDHandler, losses
from gossipy_tpu_torch.models import LogisticRegression
from gossipy_tpu_torch.optim import sgd
from gossipy_tpu_torch.random import TorchDraws
from gossipy_tpu_torch.simulation import (ChaosConfig, GossipSimulator,
                                          JSONLinesReceiver,
                                          PartitionEpisode,
                                          SequentialGossipSimulator,
                                          rounds_to_reconverge)

N_NODES = 16
PART_START, PART_STOP = 3, 6   # partition at round 3, heal at round 6
ROUNDS = 14
CHUNK = 5                      # the chunked run's first call


def build(cls, device=None, draws=None, **kwargs):
    """The chaos configuration (``scripts/chaos_smoke.py::build``) as
    ``cls`` (the bulk or the sequential engine)."""
    rng = np.random.default_rng(7)
    D = 6
    X = rng.normal(size=(480, D)).astype(np.float32)
    y = (X @ rng.normal(size=D) > 0).astype(np.int64)
    dh = ClassificationDataHandler(X, y, test_size=0.25, seed=1)
    disp = DataDispatcher(dh, n=N_NODES, eval_on_user=False)
    handler = SGDHandler(
        model=LogisticRegression(D, 2), loss=losses.cross_entropy,
        optimizer=sgd(0.2), local_epochs=1, batch_size=16, n_classes=2,
        input_shape=(D,), create_model_mode=CreateModelMode.MERGE_UPDATE)
    half = N_NODES // 2
    chaos = ChaosConfig(partitions=(PartitionEpisode(
        components=(tuple(range(half)), tuple(range(half, N_NODES))),
        start=PART_START, stop=PART_STOP),))
    return cls(handler, Topology.clique(N_NODES), disp.stacked(),
               delta=20, protocol=AntiEntropyProtocol.PUSH,
               probes=True, chaos=chaos,
               draws=draws if draws is not None else TorchDraws(11),
               device=device, **kwargs)


def gap_story(gap: np.ndarray) -> dict:
    """The gap before, during and after the partition."""
    return {"pre": float(gap[:PART_START].max()),
            "during_min": float(gap[PART_START:PART_STOP].min()),
            "peak": float(gap[PART_START:PART_STOP].max()),
            "post_min": float(gap[PART_STOP:].min())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chaos-artifacts")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    checks: dict = {}
    failures: list = []

    def check(name, ok, detail=None):
        checks[name] = {"ok": bool(ok), "detail": detail}
        if not ok:
            failures.append(name)
        print(f"[chaos-smoke] {'ok ' if ok else 'FAIL'} {name}"
              + (f" ({detail})" if detail is not None else ""), flush=True)

    # One straight run, with JSONL so the artifact carries the chaos rows.
    sim = build(GossipSimulator, dev)
    st0 = sim.init_nodes(set_seed(11))
    draws0 = draw_record(sim.draws)
    events_path = os.path.join(args.out, "events.jsonl")
    if os.path.exists(events_path):
        os.remove(events_path)
    with JSONLinesReceiver(events_path) as rx:
        sim.add_receiver(rx)
        _, rep = sim.start(clone_state(st0), n_rounds=ROUNDS)
        sim.remove_receiver(rx)
    rep.save(os.path.join(args.out, "report.json"))

    gap = np.asarray(rep.chaos_component_gap, dtype=np.float64)
    g = gap_story(gap)
    check("gap_opens_during_partition",
          g["during_min"] > max(10.0 * g["pre"], 1e-4),
          f"pre<= {g['pre']:.2e}, during>= {g['during_min']:.3f}")
    check("gap_closes_after_heal", g["post_min"] < 0.25 * g["peak"],
          f"peak {g['peak']:.3f} -> post-heal min {g['post_min']:.3f}")
    recon = rounds_to_reconverge(gap, PART_STOP, tol=0.25 * g["peak"])
    check("reconverges_within_report", recon is not None,
          f"rounds_to_reconverge={recon}")

    # Chunked across the heal: CHUNK + (ROUNDS - CHUNK) rounds through two
    # start() calls from the same initial state and draw state must
    # reproduce the straight run bit for bit.
    sim2 = build(GossipSimulator, dev)
    sim2.draws.set_state(draws0["state"])
    st2 = clone_state(st0)
    st2, r1 = sim2.start(st2, n_rounds=CHUNK)
    st2, r2 = sim2.start(st2, n_rounds=ROUNDS - CHUNK)
    chunked_gap = np.concatenate([np.asarray(r1.chaos_component_gap),
                                  np.asarray(r2.chaos_component_gap)])
    check("chunked_resume_bit_identical",
          np.array_equal(chunked_gap, gap)
          and np.array_equal(
              np.concatenate([r1.sent_per_round, r2.sent_per_round]),
              rep.sent_per_round))

    # The sequential engine's structural agreement on the same scenario.
    seq = build(SequentialGossipSimulator, dev)
    sst = seq.init_nodes(set_seed(11))
    sst, srep = seq.start(sst, n_rounds=ROUNDS)
    sgap = np.asarray(srep.chaos_component_gap, dtype=np.float64)
    sg = gap_story(sgap)
    check("sequential_gap_opens_and_closes",
          sg["during_min"] > 1e-4 and sg["post_min"] < 0.25 * sg["peak"],
          f"seq peak {sg['peak']:.3f} -> post-heal min {sg['post_min']:.3f}")

    verdict = {
        "n_nodes": N_NODES, "device": dev.type,
        "partition": {"start": PART_START, "stop": PART_STOP},
        "rounds": ROUNDS,
        "gap_per_round": [float(x) for x in gap],
        "sequential_gap_per_round": [float(x) for x in sgap],
        "rounds_to_reconverge_after_heal": recon,
        "failed_by_cause_keys": sorted(rep.failed_per_cause),
        "checks": checks,
        "ok": not failures,
    }
    with open(os.path.join(args.out, "chaos_verdict.json"), "w") as fh:
        json.dump(verdict, fh, indent=2)
        fh.write("\n")
    if failures:
        print(f"[chaos-smoke] FAILED checks: {failures}", file=sys.stderr)
        return 1
    print(f"[chaos-smoke] all checks passed; gap peak {g['peak']:.3f}, "
          f"reconverged {recon} round(s) after heal; artifacts in "
          f"{args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
