"""Gossip-as-a-service demo: heterogeneous tenants, shape-packed buckets.

Twin of the JAX package's ``examples/main_service.py``. Submits four
concurrent experiments to the multi-tenant scheduler
(:mod:`gossipy_tpu_torch.service`):

- ``alice`` / ``bob``: LogReg over spambase-shaped data, different seeds
  and fault rates: the same shape, so the packer puts them (with
  ``mallory`` below) into one bucket;
- ``carol``: an MLP over the same data: another model, its own bucket;
- ``mallory`` (on unless ``--no-trip``): the shape of alice and bob, but
  her data carries non-finite rows, so her lane trips the numerics
  sentinels: the scheduler writes her flight-recorder bundle and evicts
  her while alice and bob finish untouched.

Four tenants, two buckets (the scheduler's own count). ``alice``'s
served report is checked bit for bit against her solo
``run_experiment``: packing changes scheduling, never results.

    python3 -m gossipy_tpu_torch.examples.main_service --rounds 30 --nodes 64
    python3 -m gossipy_tpu_torch.examples.main_service --device cpu --rounds 4 --nodes 16
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile

import numpy as np

from gossipy_tpu_torch.config import ExperimentConfig, run_experiment
from gossipy_tpu_torch.examples._common import make_parser
from gossipy_tpu_torch.service import GossipService, RunQueue, RunRequest, \
    RunStatus


def tenant_data(seed: int, n: int = 1600, d: int = 30, poison: bool = False):
    """A tenant's spambase-shaped synthetic set (the service packs by
    shape: values may differ per tenant). ``poison`` plants non-finite
    feature rows, the corrupt-ingest failure the sentinels catch."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X @ rng.normal(size=d) > 0).astype(np.int64)
    if poison:
        X[: n // 8] = np.inf
    return X, y


def requests_for(args) -> list:
    """The demo's tenants: alice, bob, carol and (unless ``--no-trip``)
    mallory."""
    base = dict(n_nodes=args.nodes, model="logreg", handler="sgd",
                topology="random_regular", topology_params={"degree": 6},
                delta=20, n_rounds=args.rounds, batch_size=16)
    requests = [
        RunRequest("alice", ExperimentConfig(**base, seed=args.seed),
                   data=tenant_data(1)),
        RunRequest("bob", ExperimentConfig(**base, seed=args.seed + 1,
                                           drop_prob=0.1),
                   data=tenant_data(2)),
        RunRequest("carol",
                   ExperimentConfig(**{**base, "model": "mlp",
                                       "model_params": {
                                           "hidden_dims": [16]}},
                                    seed=args.seed + 2),
                   data=tenant_data(3)),
    ]
    if not args.no_trip:
        requests.append(RunRequest(
            "mallory", ExperimentConfig(**base, seed=args.seed + 3),
            data=tenant_data(4, poison=True)))
    return requests


def parser():
    p = make_parser("multi-tenant scheduler demo", rounds=30, nodes=64,
                    with_plot=False)
    p.add_argument("--slice", type=int, default=10,
                   help="rounds per cooperative scheduling slice")
    p.add_argument("--no-trip", action="store_true",
                   help="skip the poisoned 4th tenant (eviction demo)")
    p.add_argument("--out", default=None,
                   help="artifact root (default: a temp dir)")
    return p


def run(argv=None) -> tuple:
    """Serve the demo and check it; returns ``(row, handles, summary,
    solo)``: the printed row, the handles by tenant, the service summary
    and alice's solo report."""
    args = parser().parse_args(argv)
    out = args.out or tempfile.mkdtemp(prefix="gossipy_service_")
    requests = requests_for(args)
    queue = RunQueue()
    handles = {r.tenant: queue.submit(r) for r in requests}
    svc = GossipService(out, slice_rounds=args.slice, device=args.device)
    summary = svc.serve(queue)

    # The packing claim from the scheduler's own counters: the LogReg
    # tenants share one bucket, carol has the second.
    assert summary["n_buckets"] == 2, summary["n_buckets"]
    assert summary["megabatch_step_programs"] == 2

    # Packing must not change results: alice served == alice solo, bit
    # for bit (the sentinels on, as the service turns them on).
    cfg_alice = requests[0].config
    solo_cfg = dataclasses.replace(
        cfg_alice, simulator_params={**cfg_alice.simulator_params,
                                     "sentinels": True})
    _, solo = run_experiment(solo_cfg, data=tenant_data(1),
                             device=args.device)
    served = handles["alice"].report
    np.testing.assert_array_equal(solo.curves(local=False)["accuracy"],
                                  served.curves(local=False)["accuracy"])
    np.testing.assert_array_equal(solo.sent_per_round,
                                  served.sent_per_round)

    if not args.no_trip:
        m = handles["mallory"]
        assert m.status is RunStatus.EVICTED, m.status
        assert m.bundle_path and os.path.isdir(m.bundle_path)
        for co in ("alice", "bob"):
            assert handles[co].status is RunStatus.DONE

    row = {
        "n_buckets": summary["n_buckets"],
        "megabatch_step_programs": summary["megabatch_step_programs"],
        "alice_parity": "bit-equal",
        "tenants": {t: {
            "status": h.status.value,
            "rounds": h.rounds_completed,
            "final_accuracy": (round(h.report.final("accuracy"), 4)
                               if h.report is not None else None),
            "bundle": h.bundle_path,
        } for t, h in handles.items()},
        "out_dir": out,
    }
    return row, handles, summary, solo


def main(argv=None) -> dict:
    row = run(argv)[0]
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
    sys.exit(0)
