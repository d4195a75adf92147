"""Where does the ms/round go? Phase attribution for the round.

Twin of the JAX package's ``scripts/profile_round.py``. Times the round
in three configurations — full round, evaluation off (``eval_every`` past
the horizon) and a doubled local-epoch count (the extra epoch isolates
one epoch of training) — and differences them into a
train/exchange/eval breakdown
(:func:`gossipy_tpu_torch.telemetry.differential_phase_attribution`),
beside the analytic per-round FLOPs and bytes
(:func:`~gossipy_tpu_torch.telemetry.analytic_round_cost`) and the
achieved FLOP rate they give. The port compiles no program, so the JAX
row's XLA counts (``xla_per_round``) and HLO scopes
(``phase_scopes_in_hlo``) are null.

The round's phases are ``torch.profiler.record_function`` ranges
(:mod:`gossipy_tpu_torch.telemetry.scopes`); with ``--trace DIR`` a
profiled run (``start(profile_dir=DIR)``) is reduced to the phases it
holds and the device ms per phase and round
(:func:`~gossipy_tpu_torch.telemetry.phase_times_from_trace`).

Usage::

    python3 -m gossipy_tpu_torch.examples.profile_round        # north star
    python3 -m gossipy_tpu_torch.examples.profile_round --cnn  # flagship CNN
    python3 -m gossipy_tpu_torch.examples.profile_round --nodes 100 \\
        --rounds 200 --trace /tmp/trace
    python3 -m gossipy_tpu_torch.examples.profile_round --device cpu \\
        --nodes 16 --rounds 5

It runs on the card; ``--device cpu`` runs on the host (the CNN in fp32
there, bf16 compute on the card). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from gossipy_tpu_torch import resolve_device
from gossipy_tpu_torch.checkpoint import clone_state
from gossipy_tpu_torch.core import AntiEntropyProtocol, CreateModelMode, \
    Topology
from gossipy_tpu_torch.data import ClassificationDataHandler, DataDispatcher
from gossipy_tpu_torch.handlers import SGDHandler, losses
from gossipy_tpu_torch.models import CIFAR10Net, LogisticRegression
from gossipy_tpu_torch.optim import sgd
from gossipy_tpu_torch.random import TorchDraws
from gossipy_tpu_torch.simulation import GossipSimulator
from gossipy_tpu_torch.telemetry import ROUND_PHASES, analytic_round_cost, \
    differential_phase_attribution, phase_times_from_trace, \
    phases_in_trace_dir

SEED = 42


def build_sim(cnn: bool, n_nodes: int, local_epochs: int = 1,
              eval_every: int = 1, sampling_eval: float = 0.0,
              probes: bool = False, device=None):
    """The JAX script's configuration: a synthetic north-star set (57
    features, 46 samples a node, LogReg) or a synthetic CIFAR-shaped one
    (128 images a node, 1280 test images, CIFAR10Net), SGD 0.1, batch 32,
    MERGE_UPDATE, PUSH on ``random_regular(n, min(20, n - 1), seed=42)``,
    ``delta=100``; draws from ``TorchDraws(42)``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    dtype = None
    if cnn:
        n_train, n_test = 128 * n_nodes, 1280
        X = rng.normal(size=(n_train, 32, 32, 3)).astype(np.float32)
        y = rng.integers(0, 10, n_train)
        Xte = rng.normal(size=(n_test, 32, 32, 3)).astype(np.float32)
        yte = rng.integers(0, 10, n_test)
        dh = ClassificationDataHandler(X, y, Xte, yte)
        model, n_classes, in_shape = CIFAR10Net(), 10, (32, 32, 3)
        # bf16 compute on the card; the host profiles in fp32 (the JAX
        # script's convention for its CPU fallback).
        dtype = torch.bfloat16 if dev.type == "cuda" else None
    else:
        d = 57
        X = rng.normal(size=(46 * n_nodes, d)).astype(np.float32)
        y = (X @ rng.normal(size=d) > 0).astype(np.int64)
        dh = ClassificationDataHandler(X, y, test_size=0.2, seed=42)
        model, n_classes, in_shape = LogisticRegression(d, 2), 2, (d,)
    handler = SGDHandler(
        model, losses.cross_entropy, optimizer=sgd(0.1),
        local_epochs=local_epochs, batch_size=32, n_classes=n_classes,
        input_shape=in_shape, compute_dtype=dtype,
        create_model_mode=CreateModelMode.MERGE_UPDATE)
    disp = DataDispatcher(dh, n=n_nodes, eval_on_user=False)
    return GossipSimulator(
        handler,
        Topology.random_regular(n_nodes, min(20, n_nodes - 1), seed=42,
                                backend="networkx"),
        disp.stacked(), delta=100, protocol=AntiEntropyProtocol.PUSH,
        eval_every=eval_every, sampling_eval=sampling_eval, probes=probes,
        draws=TorchDraws(SEED), device=dev)


def _sync(sim) -> None:
    if sim.device.type == "cuda":
        torch.cuda.synchronize(sim.device)


def time_config(rounds: int, **kwargs) -> float:
    """Steady-state ms/round of one configuration: ``rounds`` rounds to
    warm up, then the same rounds from the same draws, timed."""
    sim = build_sim(**kwargs)
    state = sim.init_nodes(torch.Generator().manual_seed(SEED))
    drawn = sim.draws.get_state()
    sim.start(clone_state(state), n_rounds=rounds)
    _sync(sim)
    sim.draws.set_state(drawn)
    t0 = time.perf_counter()
    sim.start(state, n_rounds=rounds)
    _sync(sim)
    return (time.perf_counter() - t0) / rounds * 1e3


def trace_phases(cnn: bool, n_nodes: int, rounds: int, sampling: float,
                 trace_dir: str, device=None) -> dict:
    """A warm-up run, then ``rounds`` rounds under ``start(profile_dir=
    trace_dir)``: the phases the trace holds, the device ms per phase and
    round it gives, and how they were attributed."""
    sim = build_sim(cnn, n_nodes, sampling_eval=sampling, device=device)
    state = sim.init_nodes(torch.Generator().manual_seed(SEED))
    sim.start(clone_state(state), n_rounds=rounds)
    _sync(sim)
    sim.start(state, n_rounds=rounds, profile_dir=trace_dir)
    detail: dict = {}
    per_phase = phase_times_from_trace(trace_dir, detail=detail)
    return {
        "phase_scopes_in_trace": phases_in_trace_dir(trace_dir),
        "trace_phase_ms_per_round": (
            None if per_phase is None else
            {p: round(v / rounds, 3) for p, v in per_phase.items()}),
        "trace_route": detail.get("route"),
    }


def profile(cnn: bool = False, n_nodes: int = 100,
            rounds: Optional[int] = None, trace: Optional[str] = None,
            probes: bool = False, device=None) -> dict:
    """The JSON row of :func:`main` as a dict."""
    dev = resolve_device(device)
    rounds = rounds or (20 if cnn else 200)
    sampling = 0.1 if cnn else 0.0
    sim = build_sim(cnn, n_nodes, sampling_eval=sampling, device=dev)
    analytic = analytic_round_cost(sim)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    attribution = differential_phase_attribution(
        lambda **ov: build_sim(cnn, n_nodes, sampling_eval=sampling,
                               device=dev, **ov),
        rounds=rounds, seed=SEED)
    full = attribution["full_ms"]
    phases_ms = attribution["phases_ms"]
    probed = None
    if probes:
        probed = time_config(rounds, cnn=cnn, n_nodes=n_nodes,
                             sampling_eval=sampling, probes=True, device=dev)
    flops = analytic["flops_per_round"] if analytic else None
    row = {
        "config": "cnn" if cnn else "north-star",
        "backend": dev.type,
        "device_kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "n_nodes": n_nodes,
        "rounds_per_call": rounds,
        "ms_per_round": {
            "full": round(full, 3),
            "eval": round(phases_ms["eval"], 3),
            "train_one_epoch": round(phases_ms["train"], 3),
            "exchange_and_overhead":
                round(phases_ms["exchange_and_overhead"], 3),
            **({"probes_marginal": round(probed - full, 3)}
               if probed is not None else {}),
        },
        "note": attribution["note"],
        "attribution": attribution,
        "phase_scopes_in_hlo": None,
        "phase_scopes_expected": list(ROUND_PHASES),
        "xla_per_round": {"gflops": None, "gbytes_accessed": None},
        "analytic": analytic,
        "hbm_peak_bytes": (int(torch.cuda.max_memory_allocated(dev))
                           if dev.type == "cuda" else None),
        "achieved_gflops_per_s": (round(flops / (full / 1e3) / 1e9, 3)
                                  if flops else None),
    }
    if trace:
        row.update(trace_phases(cnn, n_nodes, rounds, sampling, trace,
                                device=dev))
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cnn", action="store_true",
                    help="flagship CIFAR CNN config (default: north-star "
                         "LogReg)")
    ap.add_argument("--nodes", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="also profile the full round into DIR and reduce "
                         "the trace to ms per phase")
    ap.add_argument("--probes", action="store_true",
                    help="also time the round with the gossip-dynamics "
                         "probes on and report their marginal ms/round")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    row = profile(args.cnn, args.nodes or 100, args.rounds, args.trace,
                  args.probes, args.device)
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
