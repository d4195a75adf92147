"""A run's inspectable trace artifacts, with self-checks.

Twin of ``scripts/ci_smoke_artifact.py``. Runs a small probe-, sentinel-
and perf-enabled gossip simulation (16 nodes, 12 features, LogReg SGD
0.1, batch 8, PUSH over ``random_regular(16, 4, seed=42)``, 6 rounds)
under the flight recorder and writes, into ``--out DIR``:

- ``report.json``: the run's ``SimulationReport.save`` record (probe,
  health and perf arrays included; it round-trips through
  ``SimulationReport.load``);
- ``manifest.json``: the run's ``RunManifest`` (config, versions,
  device, memory budget, probes, sentinels, sink counters and the
  ``perf`` block: the analytic FLOPs and the timing; the XLA fields are
  None, as in the port's ``perf``);
- ``events.jsonl``: the per-round JSONL rows;
- ``bundle_*/``: only when the run trips a sentinel or raises, the
  flight-recorder repro bundle (``examples/replay_bundle.py`` replays
  it); the script then exits 2. ``--poison NODE`` writes a NaN into that
  node's params before the run, to show the trip and its bundle.

It exits non-zero on any inconsistency: the artifacts must round-trip,
the staleness histograms must sum to the accepted merges, a healthy run
must be clean in every health array, and the perf rows must be present
and positive.

    python3 -m gossipy_tpu_torch.examples.ci_smoke_artifact --device cpu
    python3 -m gossipy_tpu_torch.examples.ci_smoke_artifact --out ci-artifacts
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from gossipy_tpu_torch import resolve_device, set_seed
from gossipy_tpu_torch.core import AntiEntropyProtocol, CreateModelMode, \
    Topology
from gossipy_tpu_torch.data import ClassificationDataHandler, DataDispatcher
from gossipy_tpu_torch.handlers import SGDHandler, losses
from gossipy_tpu_torch.models import LogisticRegression
from gossipy_tpu_torch.optim import sgd
from gossipy_tpu_torch.random import TorchDraws
from gossipy_tpu_torch.simulation import GossipSimulator, JSONLinesReceiver
from gossipy_tpu_torch.simulation.report import SimulationReport
from gossipy_tpu_torch.telemetry import FlightRecorder


def build_smoke_sim(nodes: int = 16, probes: bool = True,
                    sentinels: bool = True, perf: bool = True, device=None,
                    draws=None) -> GossipSimulator:
    """The smoke configuration (``scripts/ci_smoke_artifact.py::
    build_smoke_sim``), factored out so a replay can rebuild the
    identical simulator."""
    rng = np.random.default_rng(42)
    d = 12
    X = rng.normal(size=(20 * nodes, d)).astype(np.float32)
    y = (X @ rng.normal(size=d) > 0).astype(np.int64)
    dh = ClassificationDataHandler(X, y, test_size=0.25, seed=42)
    disp = DataDispatcher(dh, n=nodes, eval_on_user=False)
    handler = SGDHandler(
        model=LogisticRegression(d, 2), loss=losses.cross_entropy,
        optimizer=sgd(0.1), local_epochs=1, batch_size=8, n_classes=2,
        input_shape=(d,), create_model_mode=CreateModelMode.MERGE_UPDATE)
    return GossipSimulator(
        handler, Topology.random_regular(nodes, 4, seed=42), disp.stacked(),
        delta=20, protocol=AntiEntropyProtocol.PUSH, probes=probes,
        sentinels=sentinels, perf=perf,
        draws=draws if draws is not None else TorchDraws(42), device=device)


def check_artifacts(report, report_path: str, manifest_path: str,
                    jsonl_path: str, rounds: int, cuda: bool) -> None:
    """The consistency gates (AssertionError on the first that fails)."""
    loaded = SimulationReport.load(report_path)
    assert np.array_equal(loaded.sent_per_round, report.sent_per_round)
    assert np.array_equal(loaded.probe_stale_hist, report.probe_stale_hist)
    hist_sums = report.probe_stale_hist.sum(axis=1)
    accepted = report.probe_accepted_per_node.sum(axis=1)
    assert np.array_equal(hist_sums, accepted), (hist_sums, accepted)
    # A healthy run is provably clean end to end.
    assert np.array_equal(loaded.health_trip, report.health_trip)
    assert (report.health_trip == 0).all(), report.health_trip
    assert int(report.health_nonfinite_params.sum()) == 0
    assert (report.health_first_bad_slot == -1).all()
    assert np.isfinite(report.health_delta_norm).all()
    assert report.health_layer_names == loaded.health_layer_names
    with open(jsonl_path) as fh:
        rows = [JSONLinesReceiver.parse_line(line) for line in fh]
    assert len(rows) == rounds, len(rows)
    assert all(r["probes"] is not None for r in rows)
    assert all(r["health"] is not None for r in rows)
    assert all(r["health"]["trip"] is False for r in rows)
    with open(manifest_path) as fh:
        manifest = json.load(fh)
    assert manifest["config"]["probes"] is not None
    assert manifest["config"]["sentinels"] is not None
    # The perf block: the analytic FLOPs and the timing; no XLA fields
    # (the port compiles nothing); the peak allocation on the card.
    perf = manifest["perf"]
    assert perf is not None and perf["config"]["timing"]
    assert perf["flops_per_round_xla"] is None
    assert perf["compile_count"] == 0
    assert perf["analytic"] is not None \
        and perf["analytic"]["flops_per_round"] > 0
    assert perf["last_run"] is not None \
        and perf["last_run"]["ms_per_round"] > 0
    if cuda:
        assert perf["hbm_peak_bytes"] and perf["hbm_peak_bytes"] > 0
    assert np.isfinite(report.perf_round_ms).all() \
        and (report.perf_round_ms > 0).all()
    assert np.array_equal(loaded.perf_round_ms, report.perf_round_ms)
    assert all(r["perf"] is not None and r["perf"]["round_ms"] > 0
               for r in rows)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="ci-artifacts",
                    help="output directory (created if absent)")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--nodes", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--poison", type=int, default=None, metavar="NODE",
                    help="write a NaN into NODE's params before the run "
                         "(the sentinels trip; the bundle is written)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    sim = build_smoke_sim(args.nodes, device=dev)
    state = sim.init_nodes(set_seed(42))
    if args.poison is not None:
        state.model.params[args.poison, 0] = float("nan")
    jsonl_path = os.path.join(args.out, "events.jsonl")
    if os.path.exists(jsonl_path):
        os.remove(jsonl_path)
    recorder = FlightRecorder(args.out, chunk=args.rounds)
    with JSONLinesReceiver(jsonl_path) as rx:
        sim.add_receiver(rx)
        state, reports, bundle = recorder.run(sim, state,
                                              n_rounds=args.rounds)
        sim.remove_receiver(rx)
    report = reports[0] if len(reports) == 1 else \
        SimulationReport.concatenate(reports)
    report_path = report.save(os.path.join(args.out, "report.json"))
    manifest_path = sim.run_manifest(extra={"ci_smoke": True}).save(
        os.path.join(args.out, "manifest.json"))
    if bundle is not None:
        # A tripped run still writes every artifact, then fails loudly.
        print(f"[ci-smoke] SENTINEL TRIPPED: flight-recorder bundle at "
              f"{bundle}", file=sys.stderr)
        sys.exit(2)
    check_artifacts(report, report_path, manifest_path, jsonl_path,
                    args.rounds, dev.type == "cuda")
    accepted = int(report.probe_accepted_per_node.sum())
    out = {"report": report_path, "manifest": manifest_path,
           "events": jsonl_path, "rounds": args.rounds,
           "nodes": args.nodes, "accepted_merges": accepted,
           "sentinel_trips": 0, "device": dev.type}
    print(f"[ci-smoke] wrote {report_path}, {manifest_path}, {jsonl_path} "
          f"({args.rounds} rounds, {args.nodes} nodes, {accepted} accepted "
          "merges, 0 sentinel trips)", flush=True)
    return out


if __name__ == "__main__":
    main()
