"""Active-cohort rounds (``simulation.cohort``), held against the JAX
package's.

Both packages run one configuration from the same pool (the JAX
``init_cohort_pool`` result, converted) under the JAX draw oracle: the
cohort schedule from the same seed material, the inner rounds' peer
draws from the same keys. Held exactly: the cohort ids, sent and failed
by cause per round, the ages, phases, touched mask, coverage and active
width. Within 1e-5: the pool's params and the metrics (fp32 reduction
order of the local SGD differs). Each deliver path is held against the
same path of the JAX engine.

Also here: the configuration's checks and rejections, the schedule's
ids for every branch of ``sample_cohort``, the manifest's cohort block,
``memory_budget``'s cohort keys, the config round trip through
``run_experiment``, and the blocked pool init against ``init_nodes``.
"""

import warnings

import jax
import numpy as np
import optax
import pytest
import torch

from gossipy_tpu import config as jconfig
from gossipy_tpu.core import AntiEntropyProtocol, CreateModelMode, \
    SparseTopology, Topology
from gossipy_tpu.data import ClassificationDataHandler, DataDispatcher
from gossipy_tpu.handlers import SGDHandler, losses
from gossipy_tpu.models import LogisticRegression
from gossipy_tpu.simulation import CohortConfig as JCohortConfig
from gossipy_tpu.simulation import GossipSimulator
from gossipy_tpu.simulation.cohort import pool_bytes as jpool_bytes
from gossipy_tpu.simulation.cohort import sample_cohort as jsample_cohort
from gossipy_tpu_torch import config as tconfig
from gossipy_tpu_torch import core as tcore
from gossipy_tpu_torch.convert import params_from_jax, params_to_numpy
from gossipy_tpu_torch.handlers import ModelState as TModelState
from gossipy_tpu_torch.handlers import SGDHandler as TSGDHandler
from gossipy_tpu_torch.handlers import losses as tlosses
from gossipy_tpu_torch.models import MLP as TMLP
from gossipy_tpu_torch.models import LogisticRegression as TLogReg
from gossipy_tpu_torch.random import TorchDraws
from gossipy_tpu_torch.simulation import CohortConfig, CohortPool, \
    GossipSimulator as TGossipSimulator, NominalTopology
from gossipy_tpu_torch.simulation.cohort import pool_bytes, sample_cohort
from torch_oracle import JaxDraws

torch.set_num_threads(1)

D = 6
PARAM_TOL = 1e-5
METRIC_TOL = 1e-5


def make_data(n_shards, seed=0, samples_per=8, d=D):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=d)
    X = rng.normal(size=(n_shards * samples_per, d)).astype(np.float32)
    y = (X @ w > 0).astype(np.int64)
    disp = DataDispatcher(ClassificationDataHandler(X, y, test_size=0.25),
                          n=n_shards, eval_on_user=False)
    return disp.stacked()


def handlers(lr=0.1, d=D):
    jh = SGDHandler(model=LogisticRegression(d, 2),
                    loss=losses.cross_entropy, optimizer=optax.sgd(lr),
                    local_epochs=1, batch_size=8, n_classes=2,
                    input_shape=(d,),
                    create_model_mode=CreateModelMode.MERGE_UPDATE)
    th = TSGDHandler(TLogReg(d, 2), tlosses.cross_entropy,
                     learning_rate=lr, local_epochs=1, batch_size=8,
                     n_classes=2, input_shape=(d,))
    return jh, th


def pair(key, nominal=96, cohort=24, rpc=1, fused="multi", jtopo=None,
         ttopo=None, peer_mode="resample", data_shards=64, **kw):
    """The same cohort configuration in both engines (the port under the
    oracle of ``key``)."""
    jh, th = handlers()
    data = make_data(data_shards)
    jtopo = jtopo or Topology.random_regular(nominal, 6, seed=3)
    ttopo = ttopo or tcore.Topology(np.asarray(jtopo.adjacency))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsim = GossipSimulator(
            jh, jtopo, data, delta=20, protocol=AntiEntropyProtocol.PUSH,
            fused_merge=fused, cohort=JCohortConfig(
                size=cohort, rounds_per_cohort=rpc, peer_mode=peer_mode),
            **kw)
        tsim = TGossipSimulator(
            th, ttopo, data, delta=20, fused_merge=fused,
            cohort=CohortConfig(size=cohort, rounds_per_cohort=rpc,
                                peer_mode=peer_mode),
            draws=JaxDraws(key, init_key=key), device="cpu", **kw)
    return jsim, tsim


def port_pool(tsim, jpool) -> CohortPool:
    """The JAX pool in the port's form (SGD keeps no optimizer state)."""
    params = params_from_jax(jax.tree.map(np.asarray, jpool.model.params),
                             tsim.handler.layout).numpy()
    return CohortPool(
        model=TModelState(params, (), np.array(jpool.model.n_updates)),
        phase=np.array(jpool.phase), node_key=np.array(jpool.node_key),
        touched=np.array(jpool.touched), round=int(jpool.round))


def assert_same_pool(tsim, tpool, jpool):
    assert tpool.round == int(jpool.round)
    for got, want in ((tpool.model.n_updates, jpool.model.n_updates),
                      (tpool.phase, jpool.phase),
                      (tpool.node_key, jpool.node_key),
                      (tpool.touched, jpool.touched)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    got = params_to_numpy(torch.from_numpy(np.asarray(tpool.model.params)),
                          tsim.handler.layout)
    want = {f"Dense_0/{k}": np.asarray(v)
            for k, v in jpool.model.params["Dense_0"].items()}
    for k in want:
        diff = np.abs(got[k] - want[k]).max()
        assert diff <= PARAM_TOL, (k, float(diff))


def assert_same_report(trep, jrep):
    for field in ("sent_per_round", "failed_per_round",
                  "cohort_active_nodes"):
        np.testing.assert_array_equal(getattr(trep, field),
                                      getattr(jrep, field), err_msg=field)
    np.testing.assert_array_equal(trep.cohort_coverage,
                                  jrep.cohort_coverage)
    for cause in ("drop", "offline", "overflow"):
        np.testing.assert_array_equal(trep.failed_per_cause[cause],
                                      jrep.failed_per_cause[cause])
    tc, jc = trep.curves(False), jrep.curves(False)
    assert sorted(tc) == sorted(jc)
    for k in jc:
        np.testing.assert_allclose(tc[k], jc[k], atol=METRIC_TOL, rtol=0,
                                   equal_nan=True, err_msg=k)


@pytest.fixture(scope="module")
def key():
    return jax.random.PRNGKey(0)


# -- the configuration -------------------------------------------------------

class TestCohortConfig:
    def test_coerce(self):
        assert CohortConfig.coerce(None) is None
        cfg = CohortConfig(size=8)
        assert CohortConfig.coerce(cfg) is cfg
        assert CohortConfig.coerce(8) == cfg
        assert CohortConfig.coerce({"size": 8}) == cfg
        for bad in (lambda: CohortConfig.coerce(True),
                    lambda: CohortConfig(size=1),
                    lambda: CohortConfig(size=8, peer_mode="bogus"),
                    lambda: CohortConfig.from_dict({"size": 8, "bogus": 1}),
                    lambda: CohortConfig(size=8, prefetch=-1),
                    lambda: CohortConfig(size=8, rounds_per_cohort=0),
                    lambda: CohortConfig(size=8, pool_dir=123)):
            with pytest.raises(ValueError):
                bad()

    def test_dict_roundtrip_equals_jax(self):
        cfg = CohortConfig(size=32, rounds_per_cohort=2,
                           peer_mode="induced", prefetch=3,
                           pool_dir="/tmp/x")
        assert CohortConfig.from_dict(cfg.to_dict()) == cfg
        assert cfg.to_dict() == JCohortConfig(**cfg.to_dict()).to_dict()

    def test_rejections(self, key):
        _, th = handlers()
        data = make_data(64)
        topo = tcore.Topology.random_regular(64, 6, seed=3)

        def sim(**kw):
            return TGossipSimulator(th, topo, data, delta=20, device="cpu",
                                    **kw)
        with pytest.raises(ValueError, match="exceeds the nominal"):
            TGossipSimulator(th, tcore.Topology.clique(8), data, delta=20,
                             cohort=16, device="cpu")
        with pytest.raises(ValueError, match="mutually"):
            sim(cohort=16, chaos={"outages": [
                {"nodes": [0], "start": 1, "stop": 2}], "horizon": 3})
        s = sim(cohort=16)
        assert (s.n_nodes, s.nominal_n) == (16, 64)
        with pytest.raises(ValueError, match="init_cohort_pool"):
            s.init_nodes()
        with pytest.raises(ValueError, match="cohort"):
            s.run_repetitions(2, [1, 2])
        with pytest.raises(ValueError, match="init_nodes"):
            sim().init_cohort_pool()
        with pytest.raises(TypeError, match="CohortPool"):
            s.start(sim().init_nodes(), 1)

    def test_nominal_topology_refuses_structure(self):
        t = NominalTopology(100)
        assert t.num_nodes == 100 and repr(t) == "NominalTopology(100)"
        with pytest.raises(AttributeError, match="population size"):
            t.degrees
        _, th = handlers()
        with pytest.raises(ValueError, match="real topology"):
            TGossipSimulator(th, NominalTopology(64), make_data(64),
                             delta=20, device="cpu",
                             cohort=CohortConfig(size=8,
                                                 peer_mode="induced"))
        with pytest.raises(ValueError, match="NominalTopology"):
            TGossipSimulator(th, NominalTopology(64), make_data(64),
                             delta=20, device="cpu")


# -- the schedule ------------------------------------------------------------

# (key seed, round, N, C): the rejection-sampling branch (C * 8 < N, twice,
# once at nominal 10M), numpy's exact choice (C * 8 >= N) and C >= N.
SAMPLE_CASES = [(0, 5, 1000, 64), (3, 0, 10_000_000, 4096),
                (1, 3, 96, 24), (2, 7, 200, 25), (4, 0, 24, 24),
                (5, 11, 30, 40)]


@pytest.mark.parametrize("case", SAMPLE_CASES, ids=str)
def test_sample_cohort_ids_equal_jax(case):
    """The port's schedule gives the JAX package's ids for the same seed
    material (the oracle's, ``_seed_material(key)``)."""
    seed, r, n, c = case
    jkey = jax.random.PRNGKey(seed)
    material = JaxDraws(jkey).cohort_seed_material()
    got = sample_cohort(material, r, n, c)
    np.testing.assert_array_equal(got, jsample_cohort(jkey, r, n, c))
    assert got.dtype == np.int64 and np.unique(got).size == min(n, c)
    if c < n:
        assert not np.array_equal(got, sample_cohort(material, r + 1, n, c))


def test_torch_draws_material_is_the_seed():
    """A stream provider's cohort schedule comes from its seed, never
    from its stream (a stager samples ahead of the rounds)."""
    d = TorchDraws(2 ** 33 + 5)
    before = d.generator.get_state()
    assert d.cohort_seed_material() == [5, 2]
    assert torch.equal(d.generator.get_state(), before)
    peers = d.cohort_peers(0, 16, "cpu")
    assert peers.shape == (16,) and (peers != torch.arange(16)).all()


# -- rounds against the JAX engine -------------------------------------------

@pytest.fixture(scope="module")
def resample_runs(key):
    """Each (rounds_per_cohort, deliver path) run once in both engines:
    8 rounds from the same pool."""
    out = {}
    for rpc, fused in ((1, "multi"), (2, "multi"), (1, False)):
        jsim, tsim = pair(key, rpc=rpc, fused=fused)
        jpool = jsim.init_cohort_pool(key)
        tpool0 = port_pool(tsim, jpool)
        jp, jr = jsim.start(jpool, n_rounds=8, key=key)
        tp, tr = tsim.start(tpool0, n_rounds=8)
        out[(rpc, fused)] = (jsim, tsim, jp, jr, tp, tr)
    return out


@pytest.mark.parametrize("case", [(1, "multi"), (2, "multi"), (1, False)],
                         ids=["rpc1-multi", "rpc2-multi", "rpc1-plain"])
def test_resample_rounds_match_jax(resample_runs, key, case):
    """Several segments of resample rounds: ids, accounting, phases,
    touched, coverage and active width exactly; params and metrics
    within 1e-5."""
    jsim, tsim, jp, jr, tp, tr = resample_runs[case]
    for r in range(0, 8, case[0]):
        np.testing.assert_array_equal(
            sample_cohort(tsim.draws.cohort_seed_material(), r, 96, 24),
            jsample_cohort(key, r, 96, 24))
    assert_same_report(tr, jr)
    assert_same_pool(tsim, tp, jp)
    assert (tr.sent_per_round == 24).all()
    assert np.isclose(tr.cohort_coverage[-1], tp.touched.mean())
    assert (np.diff(tr.cohort_coverage) >= 0).all()


@pytest.mark.parametrize("n,c", [(64, 32), (24, 24)], ids=["ring64-c32",
                                                            "full-c24"])
def test_induced_rounds_match_jax(key, n, c):
    """The induced subgraph on the cohort (a sparse ring): the same
    draws, isolated nodes send nothing; at C = N the induced graph is the
    population's, and every node sends every round."""
    jtopo = SparseTopology.ring(n)
    ttopo = tcore.SparseTopology.ring(n)
    jsim, tsim = pair(key, nominal=n, cohort=c, jtopo=jtopo, ttopo=ttopo,
                      peer_mode="induced", data_shards=n)
    jpool = jsim.init_cohort_pool(key)
    tpool = port_pool(tsim, jpool)
    jp, jr = jsim.start(jpool, n_rounds=6, key=key)
    tp, tr = tsim.start(tpool, n_rounds=6)
    assert_same_report(tr, jr)
    assert_same_pool(tsim, tp, jp)
    if c == n:
        assert (tr.sent_per_round == n).all()
    else:
        assert 0 < tr.sent_per_round.sum() and (tr.sent_per_round <= c).all()


def test_sentinels_and_events_compose(key, tmp_path):
    """The sentinels carry across segments (vitals as the JAX engine's),
    and the events JSONL has one v8 row a round with the cohort block."""
    from gossipy_tpu_torch.simulation import JSONLinesReceiver
    jsim, tsim = pair(key, nominal=64, cohort=16, sentinels=True)
    jpool = jsim.init_cohort_pool(key)
    tpool = port_pool(tsim, jpool)
    path = str(tmp_path / "run.jsonl")
    with JSONLinesReceiver(path) as rx:
        tsim.add_receiver(rx)
        _, tr = tsim.start(tpool, n_rounds=4)
    _, jr = jsim.start(jpool, n_rounds=4, key=key)
    np.testing.assert_array_equal(tr.health_trip, jr.health_trip)
    assert (tr.health_trip == 0).all()
    np.testing.assert_allclose(tr.health_delta_norm, jr.health_delta_norm,
                               rtol=1e-5, atol=1e-6)
    rows = [JSONLinesReceiver.parse_line(line) for line in open(path)]
    assert len(rows) == 4
    for r, row in zip(tr.cohort_coverage, rows):
        assert row["schema"] == 8
        assert row["cohort"] == {"coverage": pytest.approx(float(r)),
                                 "active_nodes": 16}


# -- the edges: manifest, memory budget, config ------------------------------

def test_manifest_and_memory_budget_match_jax(key):
    """The manifest's cohort block and ``memory_budget``'s cohort keys
    equal the JAX engine's for the same configuration (a row width that
    needs no padding, so the pool and per-node terms are the same)."""
    d = 7          # 2 x 7 + 2 = 16 params: stride = width
    jh, th = handlers(d=d)
    data = make_data(64, d=d)
    jtopo = Topology.random_regular(64, 6, seed=3)
    ttopo = tcore.Topology(np.asarray(jtopo.adjacency))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsim = GossipSimulator(jh, jtopo, data, delta=20,
                               cohort=JCohortConfig(size=16))
    tsim = TGossipSimulator(th, ttopo, data, delta=20, fused_merge=False,
                            cohort=CohortConfig(size=16), device="cpu")
    jm = jsim.run_manifest().to_dict()["config"]
    tm = tsim.run_manifest().to_dict()["config"]
    for k in ("cohort", "nominal_n", "topology", "n_nodes"):
        assert tm[k] == jm[k], k
    assert tm["cohort"]["size"] == 16 and tm["topology"] == "Topology"
    jb, tb = jsim.memory_budget(), tsim.memory_budget()
    for k in ("cohort_size", "nominal_n", "cohort_pool_resident",
              "cohort_pool_disk_backed", "model_and_opt_bytes",
              "history_ring_bytes", "mailbox_bytes", "reply_box_bytes"):
        assert tb[k] == jb[k], k
    assert tb["cohort_pool_resident"] == pool_bytes(tsim) == \
        jpool_bytes(jsim)
    assert tb["cohort_materialized_prediction"] > tb["cohort_active_total"]
    # A padded row: the port's pool counts its stride, 4 bytes a column.
    jsim6, tsim6 = pair(key, nominal=64, cohort=16)
    pad = tsim6.handler.layout.stride - tsim6.handler.layout.width
    assert pool_bytes(tsim6) == jpool_bytes(jsim6) + 4 * pad * 64


def test_config_roundtrip_and_run_experiment():
    """The config's cohort field builds a cohort simulator and
    ``run_experiment`` inits a pool; the rejections are the JAX
    package's."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(400, D)).astype(np.float32)
    y = (X @ rng.normal(size=D) > 0).astype(np.int64)
    kw = dict(n_nodes=48, model="logreg", topology="random_regular",
              topology_params={"degree": 4}, cohort={"size": 12},
              n_rounds=5, delta=10, batch_size=8, seed=3)
    cfg = tconfig.ExperimentConfig(**kw)
    cfg2 = tconfig.ExperimentConfig.from_json(cfg.to_json())
    assert cfg2.cohort == {"size": 12}
    assert cfg.to_json() == jconfig.ExperimentConfig(**kw).to_json()
    pool, rep = tconfig.run_experiment(cfg2, data=(X, y), device="cpu")
    assert isinstance(pool, CohortPool) and pool.round == 5
    assert (rep.cohort_active_nodes == 12).all()
    assert pool.model.params.shape[0] == 48
    bad = {**kw, "simulator": "all2all"}
    for mod, extra in ((jconfig, {}), (tconfig, {"device": "cpu"})):
        with pytest.raises(ValueError, match="simulator 'gossip'"):
            mod.run_experiment(mod.ExperimentConfig(**bad), data=(X, y),
                               **extra)
        with pytest.raises(ValueError, match="repetition"):
            mod.ExperimentConfig(**{**kw, "repetitions": 2})


# -- the pool's init ---------------------------------------------------------

@pytest.mark.parametrize("model", ["logreg", "mlp"])
def test_pool_init_equals_init_nodes(model):
    """The blocked pool init (two blocks and a ragged tail) gives what
    ``init_nodes(local_train=False)`` gives under one generator, bit for
    bit, and the same phases from the same draws."""
    net = TLogReg(D, 2) if model == "logreg" else TMLP(D, 2, (5, 3))
    th = TSGDHandler(net, tlosses.cross_entropy, input_shape=(D,))
    data = make_data(10)
    topo = tcore.Topology.random_regular(10, 4, seed=1)
    plain = TGossipSimulator(th, topo, data, delta=20, device="cpu",
                             draws=TorchDraws(7))
    coh = TGossipSimulator(th, topo, data, delta=20, device="cpu",
                           draws=TorchDraws(7), cohort=4)
    st = plain.init_nodes(torch.Generator().manual_seed(3),
                          local_train=False)
    pool = coh.init_cohort_pool(torch.Generator().manual_seed(3), block=4)
    np.testing.assert_array_equal(pool.model.params,
                                  st.model.params.numpy())
    np.testing.assert_array_equal(pool.model.n_updates,
                                  st.model.n_updates.numpy())
    np.testing.assert_array_equal(pool.phase, st.phase.numpy())
    np.testing.assert_array_equal(pool.node_key[:, 1], np.arange(10))
    assert pool.round == 0 and not pool.touched.any()


def test_pool_init_blocked_at_width():
    """At the north star's width (LogReg 57 x 2, float64 uniforms) and a
    block of 1,000 rows, the blocked init equals the node-by-node one."""
    th = TSGDHandler(TLogReg(57, 2), tlosses.cross_entropy,
                     input_shape=(57,))
    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 57)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.int64)
    data = DataDispatcher(ClassificationDataHandler(X, y, test_size=0.25),
                          n=8, eval_on_user=False).stacked()
    sim = TGossipSimulator(th, NominalTopology(2500), data, delta=20,
                           device="cpu", cohort=CohortConfig(size=8))
    pool = sim.init_cohort_pool(torch.Generator().manual_seed(9),
                                block=1000)
    g = torch.Generator().manual_seed(9)
    for i in range(2500):
        want = th.init(g, "cpu").params.numpy()
        if i in (0, 999, 1000, 2499):
            np.testing.assert_array_equal(pool.model.params[i], want)
