"""Fused-deliver smoke: parity, the launch property and the deliver A/B.

Twin of ``scripts/fused_smoke.py``, through the port's entry points:

1. **Parity**: a directed-cycle fan-in-1 configuration at
   ``mailbox_slots=4`` (12 nodes, 30 features, LogisticRegression, SGD
   0.1, batch 8, MERGE_UPDATE, PUSH, 6 rounds from a common init):
   ``fused_merge="multi"`` (one K1 launch drains all K slots on the card)
   against the unfused deliver. Params bit-equal on the float32 ring;
   within 1e-6 on the int8 ring (K2 on the card: the dequantized peer is
   widened in the kernel); sent and failed accounting equal.
2. **The launch property**: kernel entries per round executed
   (``analysis.program.kernel_launch_count``) over the program gate's
   simulators: unfused 0, fused multi 1, fused compact 1 (the JAX
   program's count is 2: its ``lax.cond`` holds both branches); on the
   card ``LAUNCHES`` equals the kernel-entry log.
3. **The deliver A/B**: the deliver phase's ms a round
   (``gossipy.receive_merge``, from ``start(profile_dir=...)`` and
   ``telemetry.phase_times_from_trace``; the update pass nested in it is
   ``gossipy.train`` and is not counted) of the plain, ``per_slot`` and
   ``multi`` delivers on a K = 4 clique. On the card the JAX bench's
   regime (CIFAR10Net, 64 images a node); on the host, as the JAX script
   does off the TPU, a LogisticRegression stand-in with the same launch
   schedule (16 nodes, 30 features). ``multi`` must be strictly below
   ``per_slot`` (one launch and one pass in place of K). Beside it the
   bytes-moved model of one deliver (multi < per_slot <= plain). The row
   lands in ``--out``/fused_row.json and, with ``--ledger``, as a digest
   row of the run ledger.

Exit 0 when every gate is green, 1 on any violated invariant.

    python3 -m gossipy_tpu_torch.examples.fused_smoke --device cpu
    python3 -m gossipy_tpu_torch.examples.fused_smoke --out fused-artifacts
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from gossipy_tpu_torch import resolve_device, set_seed
from gossipy_tpu_torch.core import AntiEntropyProtocol, CreateModelMode, \
    Topology
from gossipy_tpu_torch.data import ClassificationDataHandler, DataDispatcher
from gossipy_tpu_torch.handlers import SGDHandler, losses
from gossipy_tpu_torch.models import CIFAR10Net, LogisticRegression
from gossipy_tpu_torch.optim import sgd
from gossipy_tpu_torch.random import TorchDraws
from gossipy_tpu_torch.simulation import GossipSimulator

K = 4          # mailbox depth: the multi-slot kernel's design point
PARITY_N = 12  # directed-cycle nodes (fan-in 1: bit-exact fp32 parity)
PARITY_D = 30
PARITY_ROUNDS = 6
PARITY_TOL = {"float32": 0.0, "int8": 1e-6}
AB_ROUNDS = 3
AB_NODES = 16
ROUND_LEN = 100
LEGS = {"plain": False, "per_slot": "per_slot", "multi": "multi"}


def _stamp(msg: str) -> None:
    print(f"[fused_smoke] {msg}", file=sys.stderr, flush=True)


def parity_sim(fused, history_dtype: str = "float32", device=None,
               draws=None) -> GossipSimulator:
    """The parity configuration (``scripts/fused_smoke.py::_parity_sim``)
    on the deliver ``fused`` (False or "multi")."""
    rng = np.random.default_rng(7)
    X = rng.normal(size=(PARITY_N * 24, PARITY_D)).astype(np.float32)
    y = (X @ rng.normal(size=PARITY_D) > 0).astype(np.int64)
    disp = DataDispatcher(ClassificationDataHandler(X, y, test_size=0.2),
                          n=PARITY_N, eval_on_user=False)
    handler = SGDHandler(model=LogisticRegression(PARITY_D, 2),
                         loss=losses.cross_entropy, optimizer=sgd(0.1),
                         local_epochs=1, batch_size=8, n_classes=2,
                         input_shape=(PARITY_D,),
                         create_model_mode=CreateModelMode.MERGE_UPDATE)
    # Directed cycle: every node receives from exactly one peer, so the
    # slot-iterated blend and the one-launch multi kernel walk the same
    # reductions (fan-in 1: no reassociation).
    cycle = Topology(np.roll(np.eye(PARITY_N, dtype=bool), 1, axis=1))
    return GossipSimulator(handler, cycle, disp.stacked(), delta=100,
                           protocol=AntiEntropyProtocol.PUSH,
                           fused_merge=fused, mailbox_slots=K,
                           history_dtype=history_dtype,
                           draws=draws if draws is not None
                           else TorchDraws(0), device=device)


def _run(sim, rounds: int = PARITY_ROUNDS):
    state = sim.init_nodes(set_seed(0), common_init=True)
    return sim.start(state, n_rounds=rounds)


def check_parity(report: dict, dev) -> list:
    failures = []
    for dtype, tol in PARITY_TOL.items():
        out = {leg: _run(parity_sim(fused, dtype, dev))
               for leg, fused in (("unfused", False), ("multi", "multi"))}
        (s_u, r_u), (s_m, r_m) = out["unfused"], out["multi"]
        diff = float((s_u.model.params.double()
                      - s_m.model.params.double()).abs().max())
        sent_eq = (r_u.sent_messages == r_m.sent_messages
                   and r_u.failed_messages == r_m.failed_messages)
        report.setdefault("parity", {})[dtype] = {
            "max_abs_diff": diff, "tolerance": tol,
            "sent": int(r_m.sent_messages),
            "failed": int(r_m.failed_messages),
            "accounting_bit_equal": bool(sent_eq)}
        if not diff <= tol:
            failures.append(f"parity[{dtype}]: fused-multi diverged from "
                            f"unfused by {diff:g} (> {tol:g})")
        if not sent_eq:
            failures.append(f"parity[{dtype}]: sent/failed accounting "
                            "differs between fused and unfused")
        _stamp(f"parity {dtype}: max|diff| {diff:g} (tol {tol:g}), sent "
               f"{r_m.sent_messages} "
               f"{'OK' if diff <= tol and sent_eq else 'FAIL'}")
    return failures


def check_launch_counts(report: dict, dev) -> list:
    """The program gate's launch gate (``program_gate.run_launch_gate``)."""
    from gossipy_tpu_torch.examples import program_gate
    report["launch"] = {}
    return program_gate.run_launch_gate(dev, 2, report)


def ab_sim(fused, n: int, cnn: bool, device=None) -> GossipSimulator:
    """The deliver A/B's simulator: a clique of ``n`` nodes, K = 4,
    PUSH, MERGE_UPDATE; CIFAR10Net (SGD 0.05, batch 32, 64 images a
    node) or the LogisticRegression stand-in (30 features, SGD 0.1,
    batch 8)."""
    rng = np.random.default_rng(0)
    if cnn:
        X = rng.normal(size=(n * 64, 32, 32, 3)).astype(np.float32)
        y = rng.integers(0, 10, n * 64)
        handler = SGDHandler(model=CIFAR10Net(), loss=losses.cross_entropy,
                             optimizer=sgd(0.05), local_epochs=1,
                             batch_size=32, n_classes=10,
                             input_shape=(32, 32, 3),
                             create_model_mode=CreateModelMode.MERGE_UPDATE)
    else:
        X = rng.normal(size=(n * 24, PARITY_D)).astype(np.float32)
        y = (X @ rng.normal(size=PARITY_D) > 0).astype(np.int64)
        handler = SGDHandler(model=LogisticRegression(PARITY_D, 2),
                             loss=losses.cross_entropy, optimizer=sgd(0.1),
                             local_epochs=1, batch_size=8, n_classes=2,
                             input_shape=(PARITY_D,),
                             create_model_mode=CreateModelMode.MERGE_UPDATE)
    disp = DataDispatcher(ClassificationDataHandler(X, y, test_size=0.2),
                          n=n, eval_on_user=False)
    return GossipSimulator(handler, Topology.clique(n), disp.stacked(),
                           delta=ROUND_LEN, protocol=AntiEntropyProtocol.PUSH,
                           eval_every=AB_ROUNDS, fused_merge=fused,
                           mailbox_slots=K, draws=TorchDraws(0),
                           device=device)


def deliver_ms(sim, rounds: int = AB_ROUNDS) -> tuple:
    """``(deliver ms a round, train ms a round, accepted a round)`` from
    a profiled ``start`` after a warm-up ``start``."""
    from gossipy_tpu_torch.telemetry import phase_times_from_trace
    from gossipy_tpu_torch.telemetry.scopes import PHASE_RECEIVE_MERGE, \
        PHASE_TRAIN
    state = sim.init_nodes(set_seed(0), common_init=True)
    state, _ = sim.start(state, n_rounds=1)     # warm-up (kernel build)
    with tempfile.TemporaryDirectory(prefix="fused_deliver_") as tmp:
        state, rep = sim.start(state, n_rounds=rounds, profile_dir=tmp)
        phases = phase_times_from_trace(tmp) or {}
    accepted = (rep.sent_messages - rep.failed_messages) / rounds
    rm, tr = phases.get(PHASE_RECEIVE_MERGE), phases.get(PHASE_TRAIN)
    return (None if rm is None else rm / rounds,
            None if tr is None else tr / rounds, accepted)


def check_deliver_ab(report: dict, dev, out_dir: str,
                     n: int = AB_NODES) -> list:
    failures = []
    cnn = dev.type == "cuda"
    dms, tms, acc = {}, {}, {}
    for leg, fused in LEGS.items():
        dms[leg], tms[leg], acc[leg] = deliver_ms(ab_sim(fused, n, cnn, dev))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    sim0 = ab_sim(False, n, cnn, dev)
    wire = sim0.wire_bytes_per_message()
    p_bytes = 4 * sim0._model_size()
    gather = acc["plain"] * wire

    def passes_bytes(passes, materialize=False):
        moved = passes * 2 * n * p_bytes + gather
        if materialize:
            moved += acc["plain"] * p_bytes
        return int(round(moved))

    dbm = {"plain": passes_bytes(K, materialize=True),
           "per_slot": passes_bytes(K), "multi": passes_bytes(1),
           "accepted_per_round": acc["plain"],
           "wire_bytes_per_message": wire}
    row = {"metric": "fused_deliver_ms_ab",
           "config": {"model": "CIFAR10Net" if cnn else "LogisticRegression",
                      "n_nodes": n, "rounds": AB_ROUNDS},
           "backend": dev.type,
           "device_kind": (torch.cuda.get_device_name(dev) if cnn
                           else "cpu"),
           "raw": {"deliver_ms_per_round": dms, "train_ms_per_round": tms,
                   "deliver_bytes_moved": dbm, "mailbox_slots": K}}
    with open(os.path.join(out_dir, "fused_row.json"), "w") as fh:
        json.dump(row, fh, indent=2)
        fh.write("\n")
    report["ab"] = row
    if not dbm["multi"] < dbm["per_slot"] <= dbm["plain"]:
        failures.append(f"ab: bytes-moved model out of order: {dbm}")
    if dms.get("multi") is None or dms.get("per_slot") is None:
        failures.append(f"ab: deliver-phase trace missing a leg: {dms}")
    elif not dms["multi"] < dms["per_slot"]:
        failures.append(f"ab: multi deliver phase {dms['multi']} ms not "
                        f"strictly below per_slot {dms['per_slot']} ms")
    _stamp(f"ab ({row['config']['model']}, {n} nodes): deliver ms/round "
           f"{dms}, train {tms}, bytes {dbm['multi']}/{dbm['per_slot']}/"
           f"{dbm['plain']} {'OK' if not failures else 'FAIL'}")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="fused-artifacts")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--ledger", default=None, metavar="PATH",
                    help="run-ledger file to append the A/B row's digest "
                         "to (shared with the other smokes)")
    ap.add_argument("--skip-ab", action="store_true",
                    help="parity and launch counts only")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    warnings.filterwarnings("ignore", message=r".*may overflow.*")
    os.makedirs(args.out, exist_ok=True)

    t0 = time.perf_counter()
    report: dict = {"backend": dev.type, "mailbox_slots": K, "failures": []}
    _stamp(f"device {dev}, K={K}")
    failures = check_parity(report, dev)
    failures += check_launch_counts(report, dev)
    if not args.skip_ab:
        failures += check_deliver_ab(report, dev, args.out)
        if args.ledger:
            from gossipy_tpu_torch.telemetry.ledger import (
                ingest_bench_capsule, resolve_ledger)
            led = resolve_ledger(args.ledger)
            if led is not None:
                ingest_bench_capsule(
                    led, os.path.join(args.out, "fused_row.json"),
                    source="fused_smoke")
                _stamp(f"ledger: A/B row -> {led.path}")
    report["failures"] = failures
    report["elapsed_seconds"] = time.perf_counter() - t0
    with open(os.path.join(args.out, "fused_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=2)
        fh.write("\n")
    for f in failures:
        _stamp(f"FAIL: {f}")
    _stamp(f"{'FAILED' if failures else 'PASSED'} in "
           f"{report['elapsed_seconds']:.1f} s")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
