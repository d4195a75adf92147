"""Active-cohort mode's accounting proofs, end to end.

Twin of the JAX package's ``scripts/cohort_smoke.py``, through the port's
entry points at the same sizes: nominal N = 96, C = 24, zero fault
rates, sync PUSH in resample mode, LogisticRegression(6, 2) under SGD
0.1 (batch 8, one local epoch), ``TorchDraws(11)``. Eight checks:

1. **Sampled-round accounting**: ``sent`` is C every round, nothing
   fails.
2. **Sequential-engine replay**: each round's cohort (``sample_cohort``
   of the run's seed material) replayed through the port's
   :class:`~gossipy_tpu_torch.simulation.SequentialGossipSimulator` over
   its C nodes (a clique: the resample-mode peer universe) sends the same
   count, and fails none.
3. **Chunked determinism**: 10 rounds equal 5 + 5, pool and counters bit
   for bit.
4. **Checkpoint round trip mid-run**: ``sim.save`` at round 5,
   ``sim.load`` on a fresh simulator (the zero template), continue: equal
   to the straight run.
5. **Coverage accounting**: monotone, equal to ``touched.mean()`` at the
   end, ``cohort_active_nodes`` C every round.
6. **Trace accounting**: a traced run's Chrome trace loads, its
   ``trace_report`` has one row a round with ``host_blocked_ms`` and
   ``overlap_frac``, ``host_blocked + device + unaccounted == wall``, and
   the untraced gap under 0.15 of the wall.
7. **Streaming A/B**: C = 768, 2 rounds a cohort, 256 features, 3 local
   epochs, 24 rounds, serial then ``prefetch=8``, both traced: the
   streamed pool is bit-identical to the serial one; both traces'
   ``overlap_frac`` and ``host_blocked_frac`` are recorded, and the
   streamed overlap must exceed 0.3.
8. **Nominal-100M disk pool**: ``CohortConfig(pool_dir=...)`` at N =
   100,000,000, C = 32, ``prefetch=2``: a short run completes, the rows
   written (the store's ``inited`` mask) take under 1 GB of the files'
   ~8 GB apparent size, the sparse files' allocation (``st_blocks``)
   stays under 1 GB where the filesystem keeps holes
   (``fs_keeps_holes``; a 9p mount reports the apparent size, and the
   record says so), and the memory Python and numpy allocate over the
   check peaks under 1 GB (``tracemalloc``): the pool is never
   materialized. The process's peak RSS is recorded beside; on the card
   machine's 9p mount it counts the mapped files' pages.

It writes ``cohort_smoke.json`` (every checked number) and the traces'
reports under ``--out`` and prints the record as one JSON line (``main``
returns it). It runs on the card; ``--device cpu`` runs on the host:

    python3 -m gossipy_tpu_torch.examples.cohort_smoke --out DIR
    python3 -m gossipy_tpu_torch.examples.cohort_smoke --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import sys
import tempfile
import tracemalloc

import numpy as np
import torch

from gossipy_tpu_torch import resolve_device
from gossipy_tpu_torch.core import AntiEntropyProtocol, Topology
from gossipy_tpu_torch.data import ClassificationDataHandler, DataDispatcher
from gossipy_tpu_torch.handlers import SGDHandler, losses
from gossipy_tpu_torch.models import LogisticRegression
from gossipy_tpu_torch.random import TorchDraws
from gossipy_tpu_torch.simulation import CohortConfig, GossipSimulator, \
    NominalTopology, SequentialGossipSimulator
from gossipy_tpu_torch.simulation.cohort import _leaves, fs_keeps_holes, \
    sample_cohort
from gossipy_tpu_torch.telemetry.tracing import Tracer, trace_report

N_NOMINAL, C, ROUNDS, D = 96, 24, 10, 6
SEED = 11
AB_FEATURES, AB_COHORT, AB_ROUNDS, AB_PREFETCH = 256, 768, 24, 8
BIG_NOMINAL, BIG_COHORT = 100_000_000, 32


def handler(d: int = D, epochs: int = 1) -> SGDHandler:
    return SGDHandler(LogisticRegression(d, 2), losses.cross_entropy,
                      learning_rate=0.1, local_epochs=epochs, batch_size=8,
                      n_classes=2, input_shape=(d,))


def stacked(n_shards: int, per: int, d: int, test_size: float) -> dict:
    rng = np.random.default_rng(7)
    w = rng.normal(size=d)
    X = rng.normal(size=(n_shards * per, d)).astype(np.float32)
    y = (X @ w > 0).astype(np.int64)
    return DataDispatcher(ClassificationDataHandler(X, y,
                                                    test_size=test_size),
                          n=n_shards, eval_on_user=False).stacked()


def build(device, tracing=None, draws=None) -> GossipSimulator:
    """The N = 96, C = 24 configuration (``scripts/cohort_smoke.py``'s
    ``build``); ``draws``: a draw state to resume from (the stream
    after the pool's init, so that every run here starts from the
    same)."""
    sim = GossipSimulator(
        handler(), Topology.random_regular(N_NOMINAL, 6, seed=3),
        stacked(N_NOMINAL, 6, D, 0.25), delta=20,
        protocol=AntiEntropyProtocol.PUSH, cohort=CohortConfig(size=C),
        draws=TorchDraws(SEED), tracing=tracing, device=device)
    if draws is not None:
        sim.draws.set_state(draws)
    return sim


def build_ab(device, prefetch: int, tracing=None) -> GossipSimulator:
    """Check 7's heavier configuration: C = 768, 2 rounds a cohort, [C,
    32, 256] data rows, 3 local epochs, nominal 100,000."""
    return GossipSimulator(
        handler(AB_FEATURES, 3), NominalTopology(100_000),
        stacked(4 * AB_COHORT, 32, AB_FEATURES, 0.1), delta=20,
        protocol=AntiEntropyProtocol.PUSH, sampling_eval=0.01,
        eval_every=10_000,
        cohort=CohortConfig(size=AB_COHORT, rounds_per_cohort=2,
                            prefetch=prefetch),
        draws=TorchDraws(SEED), tracing=tracing, device=device)


def build_big(device, pool_dir: str) -> GossipSimulator:
    """Check 8's nominal-100M disk-backed pool."""
    return GossipSimulator(
        handler(), NominalTopology(BIG_NOMINAL), stacked(128, 8, D, 0.25),
        delta=20, protocol=AntiEntropyProtocol.PUSH, sampling_eval=0.01,
        eval_every=10_000,
        cohort=CohortConfig(size=BIG_COHORT, prefetch=2, pool_dir=pool_dir),
        draws=TorchDraws(SEED), device=device)


def check(ok, detail=None) -> None:
    """Raise when a check fails (an ``assert`` would vanish under
    ``-O``)."""
    if not ok:
        raise RuntimeError(f"cohort_smoke check failed: {detail!r}")


def pool_leaves(pool) -> list:
    return _leaves(pool.model) + [pool.phase, pool.node_key, pool.touched]


def same_pools(a, b) -> bool:
    return a.round == b.round and all(
        np.array_equal(np.asarray(x), np.asarray(y))
        for x, y in zip(pool_leaves(a), pool_leaves(b)))


def seq_replay(sim, device) -> tuple[list, list]:
    """Check 2: each round's cohort through the sequential engine over
    its C nodes (their data rows, a clique), one round each; the
    per-round sent and failed sums."""
    material = sim.draws.cohort_seed_material()
    sent, failed = [], []
    for r in range(ROUNDS):
        idx = torch.as_tensor(sample_cohort(material, r, N_NOMINAL, C),
                              device=sim.device)
        rows = idx % sim.data["xtr"].shape[0]
        data_c = {k: (v if k in ("x_eval", "y_eval") else v[rows])
                  for k, v in sim.data.items()}
        seq = SequentialGossipSimulator(
            sim.handler, Topology.clique(C), data_c, delta=sim.delta,
            protocol=AntiEntropyProtocol.PUSH, draws=TorchDraws(SEED + r),
            device=device)
        st = seq.init_nodes(torch.Generator().manual_seed(r),
                            local_train=False)
        _, rep = seq.start(st, n_rounds=1)
        sent.append(int(rep.sent_per_round.sum()))
        failed.append(int(rep.failed_per_round.sum()))
    return sent, failed


def check_trace(snap: dict, rounds: int) -> dict:
    """Check 6's trace properties; returns the report's totals."""
    check(isinstance(snap["traceEvents"], list) and snap["traceEvents"])
    for ev in snap["traceEvents"]:
        check({"ph", "name", "pid", "tid"} <= set(ev), ev)
        if ev["ph"] == "X":
            check("ts" in ev and "dur" in ev, ev)
    report = trace_report(snap)
    check(report["n_windows"] >= 1)
    check(len(report["per_round"]) == rounds, report["per_round"])
    for row in report["per_round"]:
        check("host_blocked_ms" in row and "overlap_frac" in row, row)
    tot = report["totals"]
    gap = abs(tot["wall_ms"] - tot["host_blocked_ms"] - tot["device_ms"]
              - tot["unaccounted_ms"])
    check(gap < 1.0, (gap, tot))
    check(tot["unaccounted_frac"] is not None
          and tot["unaccounted_frac"] < 0.15, tot)
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="cohort-smoke-artifacts")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    sim = build(device)
    pool0 = sim.init_cohort_pool(torch.Generator().manual_seed(SEED))
    draws0 = sim.draws.get_state()
    record: dict = {"nominal_n": N_NOMINAL, "cohort_size": C,
                    "rounds": ROUNDS, "device": str(device)}
    pool_a, rep = sim.start(pool0, n_rounds=ROUNDS)

    # 1. sampled-round accounting.
    check((rep.sent_per_round == C).all(), rep.sent_per_round)
    check(rep.failed_per_round.sum() == 0, rep.failed_per_round)
    record["sent_per_round"] = rep.sent_per_round.tolist()
    record["failed_total"] = int(rep.failed_per_round.sum())

    # 5. coverage accounting.
    cov = rep.cohort_coverage
    check((np.diff(cov) >= 0).all(), cov)
    check(np.isclose(cov[-1], float(pool_a.touched.mean())), cov[-1])
    check((rep.cohort_active_nodes == C).all())
    record["coverage_final"] = float(cov[-1])

    # 2. the same schedule through the sequential engine.
    seq_sent, seq_failed = seq_replay(sim, device)
    check(seq_sent == rep.sent_per_round.tolist(), seq_sent)
    check(sum(seq_failed) == 0, seq_failed)
    record["seq_replay_sent"] = seq_sent

    # 3. chunked determinism (a fresh simulator: the same stream).
    sim_b = build(device, draws=draws0)
    pool_b, rep1 = sim_b.start(pool0, n_rounds=ROUNDS // 2)
    pool_b, rep2 = sim_b.start(pool_b, n_rounds=ROUNDS - ROUNDS // 2)
    check(same_pools(pool_a, pool_b), "chunked pool")
    check(np.array_equal(
        np.concatenate([rep1.sent_per_round, rep2.sent_per_round]),
        rep.sent_per_round), "chunked counters")
    record["chunked_bit_identical"] = True

    # 4. checkpoint round trip mid-run.
    sim_c = build(device, draws=draws0)
    pool_c, _ = sim_c.start(pool0, n_rounds=ROUNDS // 2)
    ck = sim_c.save(os.path.join(args.out, "ck"), pool_c)
    sim_d = build(device)
    restored, _ = sim_d.load(ck)
    check(restored.round == ROUNDS // 2 and same_pools(restored, pool_c),
          "restored pool")
    pool_d, _ = sim_d.start(restored, n_rounds=ROUNDS - ROUNDS // 2)
    check(same_pools(pool_a, pool_d), "resumed pool")
    record["checkpoint_roundtrip"] = True

    # 6. trace accounting.
    tr = Tracer(process_name="cohort_smoke")
    sim_t = build(device, tracing=tr, draws=draws0)
    sim_t.start(pool0, n_rounds=ROUNDS)
    snap = tr.snapshot()
    trace_path = tr.save(os.path.join(args.out, "trace.json"))
    report = check_trace(snap, ROUNDS)
    with open(os.path.join(args.out, "trace_report.json"), "w") as fh:
        json.dump(report, fh, indent=2)
    tot = report["totals"]
    record["trace"] = {"path": os.path.basename(trace_path),
                       "n_windows": report["n_windows"],
                       "host_blocked_frac": tot["host_blocked_frac"],
                       "overlap_frac": tot["overlap_frac"],
                       "unaccounted_frac": tot["unaccounted_frac"]}

    # 7. streaming A/B: bit-identity, and the overlap each trace shows.
    ab, pools = {}, {}
    for tag, prefetch in (("serial", 0), ("stream", AB_PREFETCH)):
        tr_ab = Tracer(process_name=f"cohort_smoke.{tag}")
        sim_ab = build_ab(device, prefetch, tracing=tr_ab)
        pools[tag], _ = sim_ab.start(
            sim_ab.init_cohort_pool(torch.Generator().manual_seed(SEED)),
            n_rounds=AB_ROUNDS)
        rep_ab = trace_report(tr_ab.snapshot())
        with open(os.path.join(args.out, f"trace_report_{tag}.json"),
                  "w") as fh:
            json.dump(rep_ab, fh, indent=2)
        ab[tag] = rep_ab["totals"]
    check(same_pools(pools["serial"], pools["stream"]),
          "streamed pool against serial")
    record["stream_ab"] = {
        "rounds": AB_ROUNDS, "prefetch": AB_PREFETCH,
        "bit_identical": True,
        "overlap_frac_serial": ab["serial"]["overlap_frac"],
        "overlap_frac_stream": ab["stream"]["overlap_frac"],
        "host_blocked_frac_serial": ab["serial"]["host_blocked_frac"],
        "host_blocked_frac_stream": ab["stream"]["host_blocked_frac"]}
    check((ab["stream"]["overlap_frac"] or 0.0) > 0.3, (
        "streaming overlap_frac "
        f"{ab['stream']['overlap_frac']} <= 0.3: the prefetch pipeline "
        "hides no host work behind the rounds"))

    # 8. the nominal-100M disk-backed pool.
    tmp_root = tempfile.mkdtemp(prefix="cohort_pool_", dir=args.out)
    try:
        pool_dir = os.path.join(tmp_root, "pool100m")
        # Python's and numpy's allocations over the check (tracemalloc
        # traces numpy's heap): a pool materialized in RAM would show.
        tracemalloc.start()
        sim_mm = build_big(device, pool_dir)
        check(sim_mm.memory_budget()["cohort_pool_disk_backed"])
        p_mm, _ = sim_mm.start(sim_mm.init_cohort_pool(), n_rounds=4)
        check(p_mm.round == 4, p_mm.round)
        logical = alloc = 0
        for f in os.listdir(pool_dir):
            st = os.stat(os.path.join(pool_dir, f))
            logical += st.st_size
            alloc += st.st_blocks * 512
        store = sim_mm._pool_store
        written = store.rows_written() * store.row_bytes()
        holes = fs_keeps_holes(pool_dir)
        rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
        heap_peak = tracemalloc.get_traced_memory()[1]
        tracemalloc.stop()
        check(logical > 2e9, logical)
        check(written < 1e9, written)
        if holes:
            check(alloc < 1e9, alloc)
        check(heap_peak < 1e9, heap_peak)
        record["pool_100m"] = {"nominal_n": BIG_NOMINAL,
                               "logical_bytes": logical,
                               "allocated_bytes": alloc,
                               "fs_keeps_holes": holes,
                               "rows_written": store.rows_written(),
                               "written_bytes": written,
                               "heap_peak_bytes": heap_peak,
                               "peak_rss_gb": rss_gb}
    finally:
        shutil.rmtree(tmp_root, ignore_errors=True)

    path = os.path.join(args.out, "cohort_smoke.json")
    with open(path, "w") as fh:
        json.dump(record, fh, indent=2)
    return record


if __name__ == "__main__":
    print(json.dumps(main()), flush=True)
    sys.exit(0)
