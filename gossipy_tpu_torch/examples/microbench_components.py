"""Component microbenchmarks of the flagship CNN round.

Twin of ``scripts/microbench_components.py``. Times the flagship round's
candidate cost centres in isolation, each the port's own code for that
part of the round, at the CIFAR10Net configuration's widths (the JAX
``bench_mfu`` sizes: 100 nodes, 10 sampled eval nodes, a 1280-sample eval
set, 128-sample shards; ``--small``: 8, 2, 64, 32):

- ``eval_vmap``: the global eval as the engine runs it
  (``population_metrics`` over the sampled nodes' params: one batched
  forward of every node's params over the eval set, in chunks of
  ``EVAL_ROWS`` rows);
- ``eval_map``: the same as a host loop over the nodes, one node's
  forward at a time;
- ``eval_single`` (times the eval nodes): one node's params on the eval
  set, the forward's floor;
- ``merge_slot``: a deliver slot's gather and blend: every node's peer
  snapshot gathered from the ``[D, N, stride]`` ring and averaged into
  its params (``handler.merge``, the plain deliver's merge);
- ``train_slot``: a deliver slot's update half, the local SGD pass of all
  N nodes (``handler.update``);
- ``train_slot_compact``: the compacted slot pass at the derived
  capacity (valid-first stable argsort, the live rows gathered, the
  ``[cap]``-wide update, scattered back: the engine's ``_take_rows`` and
  ``_put_rows``), with ~26% of the nodes live;
- ``snapshot``: the per-round ring write of all N nodes' params
  (``copy_`` into the ring's cell, in place).

The JAX script's ``eval_vmap_alt`` and ``train_slot_alt`` rows time a
second conv lowering (``conv_impl="conv"``, grouped convolutions). The
port's ``CIFAR10Net`` has one conv form, im2col and a batched matmul
(``models/nn.py::_conv3x3``), so those rows have no counterpart and
print as null.

On the card each of ``--reps`` calls after a warm-up call is timed
between its own pair of CUDA events, the card synchronised once at the
end; on the host (a harness check, not a measurement) with the host
clock. Prints ONE JSON line: each component's median ms a call
(``components``) and the fastest and slowest call (``spread_ms``).

    python3 -m gossipy_tpu_torch.examples.microbench_components
    python3 -m gossipy_tpu_torch.examples.microbench_components --small \\
        --device cpu
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from gossipy_tpu_torch import resolve_device
from gossipy_tpu_torch.core import CreateModelMode
from gossipy_tpu_torch.handlers import SGDHandler, losses
from gossipy_tpu_torch.handlers.base import ModelState, PeerModel
from gossipy_tpu_torch.models import CIFAR10Net
from gossipy_tpu_torch.optim import add_decayed_weights, chain, sgd
from gossipy_tpu_torch.simulation.engine import _put_rows, _take_rows, \
    metric_names, population_metrics

FULL = (100, 10, 1280, 128)    # nodes, eval nodes, eval set, shard
SMALL = (8, 2, 64, 32)
HISTORY_DEPTH = 2
LIVE_SHARE = 0.26              # nodes with a live second-arrival slot


def timed_calls(fn, dev, reps: int) -> list:
    """Steady-state ms of each of ``reps`` calls after one warm-up call,
    each between its own pair of CUDA events (the host clock on the
    CPU)."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(reps + 1)]
        marks[0].record()
        for m in marks[1:]:
            fn()
            m.record()
        torch.cuda.synchronize(dev)
        return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def flagship_handler() -> SGDHandler:
    """The flagship's handler: CIFAR10Net, SGD 0.05 with 1e-3 weight
    decay, batch 32, one local epoch, MERGE_UPDATE."""
    return SGDHandler(model=CIFAR10Net(), loss=losses.cross_entropy,
                      optimizer=chain(add_decayed_weights(1e-3), sgd(0.05)),
                      local_epochs=1, batch_size=32, n_classes=10,
                      input_shape=(32, 32, 3),
                      create_model_mode=CreateModelMode.MERGE_UPDATE)


def run(small: bool = False, reps: int = 10, device=None) -> dict:
    dev = resolve_device(device)
    n_nodes, n_eval, e_sz, shard = SMALL if small else FULL
    handler = flagship_handler()
    g = torch.Generator().manual_seed(0)
    rows = [handler.init(g, dev) for _ in range(n_nodes)]
    states = ModelState(torch.stack([r.params for r in rows]),
                        tuple(torch.stack(t) for t in
                              zip(*(r.opt_state for r in rows))),
                        torch.stack([r.n_updates for r in rows]))
    rng = np.random.default_rng(0)
    data = {
        "x_eval": torch.as_tensor(rng.normal(size=(e_sz, 32, 32, 3)),
                                  dtype=torch.float32, device=dev),
        "y_eval": torch.as_tensor(rng.integers(0, 10, e_sz), device=dev)}
    xtr = torch.as_tensor(rng.normal(size=(n_nodes, shard, 32, 32, 3)),
                          dtype=torch.float32, device=dev)
    ytr = torch.as_tensor(rng.integers(0, 10, (n_nodes, shard)), device=dev)
    mtr = torch.ones((n_nodes, shard), device=dev)
    names = metric_names(handler, {"xtr": xtr, "ytr": ytr, "mtr": mtr}, dev)
    perms = torch.stack([torch.randperm(shard, generator=g)
                         for _ in range(n_nodes)])[:, None].to(dev)
    eval_params = states.params[:n_eval]

    def eval_vmap():
        return population_metrics(handler, eval_params, data, names)

    def eval_map():
        return [population_metrics(handler, eval_params[i:i + 1], data,
                                   names) for i in range(n_eval)]

    def eval_single():
        return population_metrics(handler, eval_params[:1], data, names)

    ring = states.params[None].repeat(HISTORY_DEPTH, 1, 1)
    senders = torch.as_tensor(rng.integers(0, n_nodes, n_nodes), device=dev)

    def merge_slot():
        peer = PeerModel(ring[0, senders], states.n_updates[senders])
        return handler.merge(states, peer)

    def train_slot():
        return handler.update(states, (xtr, ytr, mtr), perms)

    cap = max(8, int(-(-0.48 * n_nodes) // 8) * 8)
    valid = torch.as_tensor(rng.random(n_nodes) < LIVE_SHARE, device=dev)

    def train_slot_compact():
        order = torch.argsort((~valid).to(torch.int32), stable=True)
        idx = order[:cap]
        out = handler.update(_take_rows(states, idx),
                             (xtr[idx], ytr[idx], mtr[idx]), perms[idx])
        return _put_rows(states, idx, out)

    def snapshot():
        ring[1].copy_(states.params)

    parts = {"eval_vmap": (eval_vmap, 1), "eval_map": (eval_map, 1),
             "eval_single_x_nodes": (eval_single, n_eval),
             "merge_slot": (merge_slot, 1), "train_slot": (train_slot, 1),
             "train_slot_compact": (train_slot_compact, 1),
             "snapshot": (snapshot, 1)}
    calls = {k: [t * scale for t in timed_calls(fn, dev, reps)]
             for k, (fn, scale) in parts.items()}
    res = {f"{k}_ms": float(np.median(v)) for k, v in calls.items()}
    res.update({"eval_vmap_alt_ms": None, "train_slot_alt_ms": None,
                "compact_cap": cap})
    return {
        "metric": "cnn_component_ms",
        "backend": dev.type,
        "device_kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "n_nodes": n_nodes, "n_eval_nodes": n_eval, "eval_set": e_sz,
        "shard": shard, "dtype": "float32", "reps": reps,
        "alt_conv_impl": None,
        "components": res,
        "spread_ms": {k: [min(v), max(v)] for k, v in calls.items()},
        "note": "eval_vmap is the engine's path; eval_single x nodes is "
                "the forward's floor; the *_alt rows have no counterpart "
                "(one conv form: im2col + batched matmul)",
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="tiny sizes (a host check of the harness)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.small, args.reps, args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
