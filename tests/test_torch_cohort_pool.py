"""Active-cohort rounds in the port alone: the pool's value semantics, the
streaming pipeline, checkpoints and disk-backed pools (the classes of
``tests/test_cohort.py`` past the JAX comparison in
``test_torch_cohort.py``).

Every equality here is bit for bit: a chunked run against the straight
one, a streamed run (``prefetch`` 1, 2, 8, a tail segment, cohorts that
overlap) against the serial one, a resumed run against the straight one;
the draws are one ``TorchDraws`` stream, the cohort schedule its seed.
The nominal-1M pure-averaging run mirrors the JAX test once.
"""

import json
import os
import resource

import numpy as np
import pytest
import torch

from gossipy_tpu_torch import core as tcore
from gossipy_tpu_torch.data import ClassificationDataHandler, \
    DataDispatcher
from gossipy_tpu_torch.handlers import SGDHandler, losses
from gossipy_tpu_torch.models import LogisticRegression
from gossipy_tpu_torch.random import TorchDraws
from gossipy_tpu_torch.simulation import CohortConfig, CohortPool, \
    GossipSimulator, NominalTopology, SimulationReport
from gossipy_tpu_torch.simulation.cohort import _leaves, fs_keeps_holes, \
    is_mmap_pool

torch.set_num_threads(1)

D = 6


def make_data(n_shards, seed=0, samples_per=8):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=D)
    X = rng.normal(size=(n_shards * samples_per, D)).astype(np.float32)
    y = (X @ w > 0).astype(np.int64)
    disp = DataDispatcher(ClassificationDataHandler(X, y, test_size=0.25),
                          n=n_shards, eval_on_user=False)
    return disp.stacked()


def make_sim(nominal=96, cohort=24, prefetch=0, rpc=1, pool_dir=None,
             lr=0.1, topo=None, **kw):
    h = SGDHandler(LogisticRegression(D, 2), losses.cross_entropy,
                   learning_rate=lr, local_epochs=1, batch_size=8,
                   n_classes=2, input_shape=(D,))
    topo = topo or tcore.Topology.random_regular(nominal, 6, seed=3)
    return GossipSimulator(
        h, topo, make_data(min(topo.num_nodes, 64)), delta=20,
        cohort=CohortConfig(size=cohort, rounds_per_cohort=rpc,
                            prefetch=prefetch, pool_dir=pool_dir),
        draws=TorchDraws(5), device="cpu", **kw)


def pool_leaves(pool):
    return _leaves(pool.model) + [pool.phase, pool.node_key, pool.touched]


def assert_pools_equal(a, b):
    assert a.round == b.round
    for x, y in zip(pool_leaves(a), pool_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.fixture(scope="module")
def serial8():
    """The 8-round serial pool and report of ``make_sim()``: the oracle
    the streaming and checkpoint tests compare against."""
    sim = make_sim()
    return sim.start(sim.init_cohort_pool(), n_rounds=8)


class TestPoolSemantics:
    def test_chunked_equals_straight(self):
        """One 10-round run equals 5 + 5, pool and counters bit for bit."""
        a, b = make_sim(), make_sim()
        pa, ra = a.start(a.init_cohort_pool(), n_rounds=10)
        pb, r1 = b.start(b.init_cohort_pool(), n_rounds=5)
        pb, r2 = b.start(pb, n_rounds=5)
        assert_pools_equal(pa, pb)
        cat = SimulationReport.concatenate([r1, r2])
        np.testing.assert_array_equal(cat.sent_per_round, ra.sent_per_round)
        np.testing.assert_array_equal(cat.cohort_coverage,
                                      ra.cohort_coverage)
        np.testing.assert_array_equal(cat.curves(False)["accuracy"],
                                      ra.curves(False)["accuracy"])

    def test_caller_pool_not_mutated(self):
        sim = make_sim(nominal=64, cohort=16)
        pool0 = sim.init_cohort_pool()
        before = [np.array(x) for x in pool_leaves(pool0)]
        pool1, _ = sim.start(pool0, n_rounds=4)
        for a, b in zip(before, pool_leaves(pool0)):
            np.testing.assert_array_equal(a, b)
        assert pool0.round == 0 and pool1.round == 4
        assert pool1.touched.any()

    def test_default_report_has_no_cohort_fields(self):
        h = SGDHandler(LogisticRegression(D, 2), losses.cross_entropy,
                       input_shape=(D,))
        sim = GossipSimulator(h, tcore.Topology.random_regular(16, 4,
                                                               seed=1),
                              make_data(16), delta=20, device="cpu")
        _, rep = sim.start(sim.init_nodes(), n_rounds=2)
        assert rep.cohort_coverage is None
        assert rep.cohort_active_nodes is None
        assert rep.to_dict()["cohort_coverage"] is None

    def test_pool_init_options(self):
        """``common_init`` gives every row the same weights;
        ``local_train`` takes one pre-training pass (ages 1, params
        moved) from the same initial rows."""
        sim = make_sim(nominal=40, cohort=8)
        base = sim.init_cohort_pool(torch.Generator().manual_seed(1),
                                    block=16)
        common = sim.init_cohort_pool(torch.Generator().manual_seed(1),
                                      common_init=True)
        assert (common.model.params == common.model.params[0]).all()
        trained = sim.init_cohort_pool(torch.Generator().manual_seed(1),
                                       local_train=True, block=16)
        assert (trained.model.n_updates == 1).all()
        assert (base.model.n_updates == 0).all()
        assert not np.array_equal(trained.model.params, base.model.params)
        assert np.isfinite(trained.model.params).all()

    def test_report_fields_survive_save_load(self):
        sim = make_sim(nominal=64, cohort=16)
        _, rep = sim.start(sim.init_cohort_pool(), n_rounds=3)
        d = rep.to_dict()
        json.dumps(d)
        back = SimulationReport.from_dict(d)
        np.testing.assert_allclose(back.cohort_coverage,
                                   rep.cohort_coverage, rtol=1e-6)
        assert back.cohort_active_nodes.dtype.kind == "i"

    def test_accounting_coverage_and_tracing(self):
        """sent = C a round, coverage monotone up to the touched share;
        a traced run has every cohort span and one window a segment."""
        from gossipy_tpu_torch.telemetry.tracing import Tracer, trace_report
        tr = Tracer()
        sim = make_sim(nominal=64, cohort=16, rpc=2, tracing=tr)
        pool, rep = sim.start(sim.init_cohort_pool(), n_rounds=6)
        assert (rep.sent_per_round == 16).all()
        assert (rep.failed_per_round == 0).all()
        cov = rep.cohort_coverage
        assert (np.diff(cov) >= 0).all()
        assert np.isclose(cov[-1], pool.touched.mean())
        names = {e["name"] for e in tr.snapshot()["traceEvents"]}
        for part in ("start", "segment", "sample", "gather", "stage", "run",
                     "fetch", "scatter"):
            assert f"cohort.{part}" in names, part
        assert "cohort.compile" not in names
        report = trace_report(tr.snapshot())
        assert report["n_windows"] == 3
        assert len(report["per_round"]) == 6


    def test_perf_metrics_and_ledger(self, tmp_path):
        """``perf=``, ``metrics=`` and ``ledger=`` on a cohort run: the
        ``perf_*`` rows and summary, the registry's counters, one ledger
        row a ``start``; the pool as with them off."""
        from gossipy_tpu_torch.telemetry import RunLedger
        path = str(tmp_path / "runs.jsonl")
        on = make_sim(nominal=64, cohort=16, perf=True, metrics=True,
                      ledger=path)
        off = make_sim(nominal=64, cohort=16)
        p_on, rep = on.start(on.init_cohort_pool(), n_rounds=3)
        p_off, _ = off.start(off.init_cohort_pool(), n_rounds=3)
        assert_pools_equal(p_on, p_off)
        assert rep.perf_round_ms.shape == (3,) and \
            (rep.perf_round_ms > 0).all()
        assert on.perf_summary()["last_run"]["rounds"] == 3
        assert on._metrics_base == {"rounds": 3, "sent": 48, "failed": 0}
        rows = RunLedger(path).rows()
        assert len(rows) == 1 and rows[0]["extra"]["rounds"] == 3


class TestStreamingPipeline:
    """``prefetch=k``: a pure scheduling change, bit-identical pools."""

    @pytest.mark.parametrize("prefetch", [1, 2, 8])
    def test_streaming_equals_serial(self, serial8, prefetch):
        p_serial, r_serial = serial8
        sim = make_sim(prefetch=prefetch)
        p, r = sim.start(sim.init_cohort_pool(), n_rounds=8)
        assert_pools_equal(p_serial, p)
        np.testing.assert_array_equal(r_serial.sent_per_round,
                                      r.sent_per_round)
        np.testing.assert_array_equal(r_serial.cohort_coverage,
                                      r.cohort_coverage)
        np.testing.assert_array_equal(r_serial.curves(False)["accuracy"],
                                      r.curves(False)["accuracy"])

    def test_streaming_tail_segment(self):
        a, b = make_sim(rpc=3), make_sim(prefetch=2, rpc=3)
        pa, _ = a.start(a.init_cohort_pool(), n_rounds=7)
        pb, _ = b.start(b.init_cohort_pool(), n_rounds=7)
        assert_pools_equal(pa, pb)

    def test_streaming_overlapping_cohorts_patch(self):
        """At N / C = 2 consecutive cohorts intersect, so staged gathers
        must be patched with in-flight outputs."""
        a = make_sim(nominal=32, cohort=16)
        b = make_sim(nominal=32, cohort=16, prefetch=3)
        pa, _ = a.start(a.init_cohort_pool(), n_rounds=10)
        pb, _ = b.start(b.init_cohort_pool(), n_rounds=10)
        assert_pools_equal(pa, pb)


    def test_streaming_under_thread_switch_stress(self):
        """Cohorts that overlap (N / C = 2) at the deepest prefetch, with
        the interpreter switching threads every microsecond: a scatter
        lost or applied out of order would change the pool."""
        import sys
        a = make_sim(nominal=32, cohort=16)
        b = make_sim(nominal=32, cohort=16, prefetch=8)
        pa, _ = a.start(a.init_cohort_pool(), n_rounds=12)
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            pb, _ = b.start(b.init_cohort_pool(), n_rounds=12)
        finally:
            sys.setswitchinterval(old)
        assert_pools_equal(pa, pb)


class TestCheckpoints:
    def test_ram_pool_midrun_roundtrip(self, serial8, tmp_path):
        """save and load mid-run under prefetch (a fresh simulator, the
        zero template), then continue: equal to the straight serial run;
        the draw state rides along."""
        s1 = make_sim(prefetch=2)
        pool, _ = s1.start(s1.init_cohort_pool(), n_rounds=4)
        path = s1.save(str(tmp_path / "ck"), pool)
        s2 = make_sim(prefetch=2)
        restored, draws = s2.load(path)
        assert draws is s2.draws and restored.round == 4
        assert_pools_equal(pool, restored)
        cont, _ = s2.start(restored, n_rounds=4)
        assert_pools_equal(cont, serial8[0])


class TestDiskBackedPool:
    def test_create_run_resume(self, tmp_path):
        pd = str(tmp_path / "pool")
        s1 = make_sim(prefetch=2, pool_dir=pd)
        pool = s1.init_cohort_pool()
        assert is_mmap_pool(pool) and isinstance(pool.model.params,
                                                  np.memmap)
        assert s1.memory_budget()["cohort_pool_disk_backed"]
        pool, rep = s1.start(pool, n_rounds=4)
        assert (rep.sent_per_round == 24).all()
        s2 = make_sim(pool_dir=pd)
        assert s2.init_cohort_pool().round == 4

    def test_checkpoint_restore_continue(self, tmp_path):
        """A checkpoint is a copy of the files; a restored run continues
        as the uninterrupted disk-backed run; lazy rows do not depend on
        the order they were first sampled in (serial against streamed,
        two fresh stores)."""
        s1 = make_sim(prefetch=2, pool_dir=str(tmp_path / "a"))
        mid, _ = s1.start(s1.init_cohort_pool(), n_rounds=3)
        ck = s1.save(str(tmp_path / "ck"), mid)
        s1b = make_sim(prefetch=2, pool_dir=str(tmp_path / "a"))
        restored, draws = s1b.load(ck)
        assert restored.round == 3 and draws is s1b.draws
        fin_a, _ = s1b.start(restored, n_rounds=3)
        s2 = make_sim(pool_dir=str(tmp_path / "b"))
        fin_b, _ = s2.start(s2.init_cohort_pool(), n_rounds=6)
        for x, y in zip(_leaves(fin_a.model), _leaves(fin_b.model)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        np.testing.assert_array_equal(np.asarray(fin_a.touched),
                                      np.asarray(fin_b.touched))

    def test_local_train_and_id_limit_rejected(self, tmp_path):
        sim = make_sim(pool_dir=str(tmp_path / "p"))
        with pytest.raises(ValueError, match="local_train"):
            sim.init_cohort_pool(local_train=True)
        big = make_sim(topo=NominalTopology(2 ** 31), cohort=8,
                       pool_dir=str(tmp_path / "big"))
        with pytest.raises(ValueError, match="int32"):
            big.init_cohort_pool()

    def test_sparse_allocation(self, tmp_path):
        """Nominal 20M on disk: the files have the nominal size, the
        store wrote only the sampled rows, and the blocks (where the
        filesystem keeps holes, as it does here) hold only those."""
        pd = str(tmp_path / "sparse")
        sim = make_sim(topo=NominalTopology(20_000_000), cohort=32,
                       prefetch=2, pool_dir=pd)
        pool, _ = sim.start(sim.init_cohort_pool(), n_rounds=3)
        assert pool.round == 3 and int(pool.touched.sum()) > 0
        logical = sum(os.stat(os.path.join(pd, f)).st_size
                      for f in os.listdir(pd))
        allocated = sum(os.stat(os.path.join(pd, f)).st_blocks * 512
                        for f in os.listdir(pd))
        assert logical > 1e9
        store = sim._pool_store
        assert 0 < store.rows_written() <= 3 * 32
        if fs_keeps_holes(pd):
            assert allocated < 5e7, allocated


class TestMillionNodePool:
    def test_nominal_1m_pure_averaging_converges(self):
        """Nominal N = 1M, C = 4096 on the device, lr = 0 (pure sampled
        averaging): the pool's variance shrinks, coverage is monotone and
        between half of and all of R C / N, the materialized prediction
        dwarfs the active round."""
        n, c, rounds = 1_000_000, 4096, 30
        h = SGDHandler(LogisticRegression(D, 2), losses.cross_entropy,
                       learning_rate=0.0, local_epochs=1, batch_size=8,
                       n_classes=2, input_shape=(D,))
        sim = GossipSimulator(h, NominalTopology(n), make_data(64),
                              delta=20, eval_every=rounds,
                              sampling_eval=0.01,
                              cohort=CohortConfig(size=c),
                              draws=TorchDraws(0), device="cpu")
        assert sim.n_nodes == c and sim.nominal_n == n
        pool = sim.init_cohort_pool()

        def variance(p):
            flat = p.model.params.astype(np.float64)
            return float(((flat - flat.mean(0)) ** 2).sum())

        v0 = variance(pool)
        pool, rep = sim.start(pool, n_rounds=rounds)
        v1 = variance(pool)
        assert 0 < v1 < 0.97 * v0, (v0, v1)
        cov = rep.cohort_coverage
        assert (np.diff(cov) >= 0).all()
        expected = rounds * c / n
        assert 0.5 * expected < cov[-1] <= expected + 1e-9
        mb = sim.memory_budget()
        assert mb["cohort_materialized_prediction"] \
            > 20 * mb["cohort_active_total"]
        rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
        assert rss_gb < 8, rss_gb
        assert isinstance(pool, CohortPool)
