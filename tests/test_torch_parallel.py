"""The port's meshes and the engine's, All2All's, the cohort's and the
service's ``mesh=`` on a CPU virtual mesh, against the unsharded runs and
the JAX package's mesh runs.

Each test of ``tests/test_parallel.py`` has a counterpart here. A port
mesh over positions that all name the CPU (``make_mesh(8, devices=
["cpu"] * 8)``) stands for the JAX package's conftest mesh of 8 virtual
CPU devices: the leaves of a placed state stay whole tensors, their
placement recorded (``parallel.sharding_of``), and the engine's
``mesh=`` runs the fused deliver as a ring over the node axis (K1's
plain version on every hop here). Deliberate difference: the params are
one flat ``[N, stride]`` leaf, so on a TP mesh the model axis lands on
``stride`` (``("nodes", "model")``) where the JAX MLP kernel gets
``("nodes", None, "model")``. The cross-package tests run
``GossipSimulator(mesh=)`` and ``All2AllGossipSimulator(mesh=,
ring_mix=True)`` under the JAX draw oracle against the JAX package's own
mesh runs: accounting exact, params within 1e-5
(``torch_pairs.assert_same_run``).
"""

import json
import warnings

import jax
import numpy as np
import pytest
import torch

from gossipy_tpu import core as jcore
from gossipy_tpu import parallel as jparallel
from gossipy_tpu import simulation as jsimulation
from gossipy_tpu_torch import core as tcore
from gossipy_tpu_torch import parallel
from gossipy_tpu_torch.data import ClassificationDataHandler, DataDispatcher
from gossipy_tpu_torch.handlers import SGDHandler, losses
from gossipy_tpu_torch.models import MLP, LogisticRegression
from gossipy_tpu_torch.parallel import (Position, make_mesh, make_mesh_2d,
                                        make_mesh_tp, shard_data, shard_state,
                                        sharding_of, state_shardings)
from gossipy_tpu_torch.random import TorchDraws
from gossipy_tpu_torch.simulation import All2AllGossipSimulator, \
    GossipSimulator
from torch_oracle import JaxDraws
from torch_pairs import assert_same_run, logreg, small_data, to_port_state

torch.set_num_threads(1)
D = 6


def dataset(n_nodes=16, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=D)
    X = rng.normal(size=(n_nodes * 12, D)).astype(np.float32)
    y = (X @ w > 0).astype(np.int64)
    return DataDispatcher(ClassificationDataHandler(X, y, test_size=0.25),
                          n=n_nodes).stacked()


def build(n_nodes=16, data=None, model=None, **kw):
    handler = SGDHandler(model or MLP(D, 2, hidden_dims=(8,)),
                         losses.cross_entropy, learning_rate=0.2,
                         local_epochs=1, batch_size=4, n_classes=2,
                         input_shape=(D,))
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=r"mailbox_slots=")
        return GossipSimulator(
            handler, tcore.Topology.clique(n_nodes),
            dataset(n_nodes) if data is None else data, delta=10,
            protocol=tcore.AntiEntropyProtocol.PUSH,
            delay=tcore.UniformDelay(0, 12), draws=TorchDraws(1),
            device="cpu", **kw)


def run(sim, state, rounds):
    return sim.start(state, n_rounds=rounds)


def init(sim):
    return sim.init_nodes(torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, devices=["cpu"] * 8)


def across_processes(n=2):
    """A mesh whose positions belong to two processes (no process group
    needed to build one)."""
    return make_mesh(devices=[Position(torch.device("cpu"), r % 2, r)
                              for r in range(n)])


# -- placement logic ---------------------------------------------------------------

class FakeDev:
    """Stand-in position for placement-logic tests: an id and the rank
    that owns it (``process_index`` too, for the JAX function)."""

    def __init__(self, id, rank):
        self.id = id
        self.rank = rank
        self.process_index = rank

    def __repr__(self):
        return f"d{self.id}@h{self.rank}"

    def __eq__(self, other):
        return (self.id, self.rank) == (other.id, other.rank)

    def __hash__(self):
        return hash((self.id, self.rank))


class TestTpDeviceGrid:
    """Rank-contiguous TP placement (multi-process make_mesh_tp)."""

    def test_model_groups_stay_intra_host(self):
        from gossipy_tpu_torch.parallel import _tp_device_grid
        devs = [FakeDev(i, i // 4) for i in range(16)]
        grid = _tp_device_grid(devs, 8, 2)
        assert grid.shape == (8, 2)
        for row in grid:
            assert len({d.rank for d in row}) == 1
        assert {d.rank for d in grid[:, 0]} == {0, 1, 2, 3}
        assert len({d.id for d in grid.ravel()}) == 16

    def test_interleaved_device_order_is_regrouped(self):
        from gossipy_tpu_torch.parallel import _tp_device_grid
        devs = [FakeDev(i, i % 4) for i in range(16)]
        for row in _tp_device_grid(devs, 8, 2):
            assert len({d.rank for d in row}) == 1

    def test_model_axis_exceeding_host_raises(self):
        from gossipy_tpu_torch.parallel import _tp_device_grid
        devs = [FakeDev(i, i // 4) for i in range(16)]
        with pytest.raises(ValueError, match="divide the per-host"):
            _tp_device_grid(devs, 2, 8)

    def test_uneven_hosts_raise(self):
        from gossipy_tpu_torch.parallel import _tp_device_grid
        devs = [FakeDev(i, 0 if i < 5 else 1) for i in range(8)]
        with pytest.raises(ValueError, match="uneven"):
            _tp_device_grid(devs, 4, 2)

    def test_single_host_matches_plain_reshape(self):
        from gossipy_tpu_torch.parallel import _tp_device_grid
        devs = [FakeDev(i, 0) for i in range(8)]
        grid = _tp_device_grid(devs, 4, 2)
        assert [d.id for d in grid.ravel()] == list(range(8))

    @pytest.mark.parametrize("layout", ["blocks", "round-robin", "single"])
    def test_grid_equals_jax(self, layout):
        from gossipy_tpu.parallel import _tp_device_grid as jgrid
        from gossipy_tpu_torch.parallel import _tp_device_grid
        host = {"blocks": lambda i: i // 4, "round-robin": lambda i: i % 4,
                "single": lambda i: 0}[layout]
        devs = [FakeDev(i, host(i)) for i in range(16)]
        got = _tp_device_grid(devs, 8, 2)
        want = jgrid(devs, 8, 2)
        assert [d.id for d in got.ravel()] == [d.id for d in want.ravel()]


def test_mesh_has_8_devices(mesh):
    assert mesh.devices.size == 8
    assert mesh.shape == {"nodes": 8}
    assert mesh.is_virtual() and mesh.device() == torch.device("cpu")
    with pytest.raises(ValueError, match="requested 9 devices"):
        make_mesh(9, devices=["cpu"] * 8)


def test_mesh_constructors_mirror_jax():
    m2 = make_mesh_2d(2, 4, devices=["cpu"] * 8)
    assert m2.shape == {"dcn": 2, "nodes": 4}
    assert m2.shape == dict(jparallel.make_mesh_2d(2, 4).shape)
    tp = make_mesh_tp(4, 2, devices=["cpu"] * 8)
    assert tp.shape == {"nodes": 4, "model": 2}
    assert tp.shape == dict(jparallel.make_mesh_tp(4, 2).shape)
    # Two processes of 3 positions each: a row of 4 would straddle them.
    devs = [Position(torch.device("cpu"), r // 3, r) for r in range(6)]
    with pytest.raises(ValueError, match="straddle"):
        make_mesh_2d(1, 4, devices=devs)
    assert make_mesh_2d(2, 3, devices=devs).shape == {"dcn": 2, "nodes": 3}
    assert parallel.devices("cpu") == [Position(torch.device("cpu"), 0, 0)]


def test_sharded_run_matches_unsharded(mesh):
    sim = build()
    _, rep_plain = run(sim, init(sim), 4)
    sim_sh = build(data=shard_data(dataset(), mesh))
    st_sh = shard_state(init(sim_sh), mesh)
    assert sharding_of(st_sh.model.params).spec[0] == "nodes"
    _, rep_sh = run(sim_sh, st_sh, 4)
    np.testing.assert_array_equal(rep_plain.curves(local=False)["accuracy"],
                                  rep_sh.curves(local=False)["accuracy"])
    assert rep_plain.sent_messages == rep_sh.sent_messages


def test_pens_sharded_run_matches_unsharded(mesh):
    """PENS's aux ([N, max_deg] counters, [N, S] model cache) places on
    the node axis like every other leaf, and the run is the same."""
    from gossipy_tpu_torch.simulation import PENSGossipSimulator

    def build_pens(data=None):
        handler = SGDHandler(MLP(D, 2, hidden_dims=(8,)),
                             losses.cross_entropy, learning_rate=0.2,
                             local_epochs=1, batch_size=4, n_classes=2,
                             input_shape=(D,),
                             create_model_mode=tcore.CreateModelMode
                             .MERGE_UPDATE)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return PENSGossipSimulator(
                handler, tcore.Topology.clique(16),
                dataset() if data is None else data, delta=10, n_sampled=4,
                m_top=2, step1_rounds=3, draws=TorchDraws(1), device="cpu")

    sim = build_pens()
    _, rep_plain = run(sim, init(sim), 5)
    sim_sh = build_pens(shard_data(dataset(), mesh))
    st_sh = shard_state(init(sim_sh), mesh)
    assert sharding_of(st_sh.aux["selected"]).spec[0] == "nodes"
    _, rep_sh = run(sim_sh, st_sh, 5)
    np.testing.assert_array_equal(rep_plain.curves(local=False)["accuracy"],
                                  rep_sh.curves(local=False)["accuracy"])


def test_state_shardings_structure(mesh):
    sh = state_shardings(init(build()), mesh)
    assert sh.model.params.spec[0] == "nodes"
    assert sh.mailbox.sender.spec[1] == "nodes"


def test_sharded_state_is_distributed(mesh):
    st = shard_state(init(build()), mesh)
    placement = sharding_of(st.model.params)
    assert placement.positions == 8
    assert placement.device_set == {torch.device("cpu")}
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        shard_state(init(build()), across_processes())
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        shard_data(dataset(), across_processes())


def build_fused(mesh=None, data=None, **kw):
    return build(data=data, model=LogisticRegression(D, 2),
                 fused_merge="multi", mailbox_slots=4, mesh=mesh, **kw)


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
def test_fused_multi_sharded_matches_unsharded(mesh, wire):
    """``GossipSimulator(mesh=)``: the deliver's multi-slot merge runs as a
    ring over the node axis in its composed linear form, so the run
    matches the unsharded fused run up to float reassociation, with
    equal sent and failed accounting (a bf16 or int8 ring widened before
    it enters the ring)."""
    sim = build_fused(history_dtype=wire)
    fs, rep_plain = run(sim, init(sim), 4)
    sim_sh = build_fused(mesh, shard_data(dataset(), mesh),
                         history_dtype=wire)
    fs_sh, rep_sh = run(sim_sh, shard_state(init(sim_sh), mesh), 4)
    np.testing.assert_allclose(fs_sh.model.params.numpy(),
                               fs.model.params.numpy(), rtol=1e-4, atol=1e-5)
    assert rep_plain.sent_messages == rep_sh.sent_messages
    assert rep_plain.failed_messages == rep_sh.failed_messages


def test_mesh_refusals(mesh):
    with pytest.raises(ValueError, match="fused_merge"):
        build(mesh=mesh, fused_merge=False)
    with pytest.raises(ValueError, match="divide"):
        build_fused(make_mesh(3, devices=["cpu"] * 3))
    with pytest.raises(ValueError, match="compact_deliver"):
        build_fused(mesh, compact_deliver=4)
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        build_fused(across_processes())
    with pytest.raises(ValueError, match="cohort-mode"):
        sim = build_fused(mesh)
        sim.start(init(sim), n_rounds=1, mesh=mesh)


def test_2d_mesh_run_matches_unsharded():
    """(dcn, nodes): the ring runs over hosts x positions."""
    mesh = make_mesh_2d(2, 4, devices=["cpu"] * 8)
    sim = build_fused()
    fs, rep_plain = run(sim, init(sim), 3)
    sim_sh = build_fused(mesh, shard_data(dataset(), mesh))
    st_sh = shard_state(init(sim_sh), mesh)
    assert sharding_of(st_sh.model.params).positions == 8
    fs_sh, rep_sh = run(sim_sh, st_sh, 3)
    np.testing.assert_allclose(fs_sh.model.params.numpy(),
                               fs.model.params.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(rep_plain.curves(local=False)["accuracy"],
                               rep_sh.curves(local=False)["accuracy"],
                               rtol=1e-4, atol=1e-5)


def test_tp_mesh_run_matches_unsharded():
    """(nodes, model): the flat params take the model axis on their
    stride; the ring runs over the node axis."""
    mesh = make_mesh_tp(4, 2, devices=["cpu"] * 8)
    sim = build_fused()
    fs, rep_plain = run(sim, init(sim), 3)
    sim_sh = build_fused(mesh, shard_data(dataset(), mesh))
    st_sh = shard_state(init(sim_sh), mesh)
    assert sim_sh.handler.layout.stride % 2 == 0
    assert sharding_of(st_sh.model.params).spec == ("nodes", "model")
    assert sharding_of(st_sh.model.params).positions == 8
    fs_sh, rep_sh = run(sim_sh, st_sh, 3)
    np.testing.assert_allclose(fs_sh.model.params.numpy(),
                               fs.model.params.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(rep_plain.curves(local=False)["accuracy"],
                               rep_sh.curves(local=False)["accuracy"],
                               rtol=1e-4, atol=1e-5)


def test_sim_save_load_roundtrip(tmp_path):
    sim = build()
    st, _ = run(sim, init(sim), 2)
    path = sim.save(str(tmp_path / "ck"), st)
    restored, _ = build().load(path)
    for (p, a), (_, b) in zip(parallel.rules.named_leaves(st),
                              parallel.rules.named_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=p)


def test_load_into_tp_mesh(tmp_path):
    """A checkpoint taken unsharded restores into a DP x TP mesh (values
    unchanged, placement per the registry) and the run continues as the
    unsharded continuation."""
    mesh = make_mesh_tp(4, 2, devices=["cpu"] * 8)
    sim = build_fused()
    st, _ = run(sim, init(sim), 2)
    draws = sim.draws.get_state()
    path = sim.save(str(tmp_path / "ck"), st)
    cont = parallel.rules.tree_map_with_path(
        lambda _, x: x.clone() if isinstance(x, torch.Tensor) else x, st)
    _, rep_plain = run(sim, cont, 2)

    sim_sh = build_fused(mesh, shard_data(dataset(), mesh))
    restored, rdraws = sim_sh.load(path, mesh=mesh)
    assert torch.equal(rdraws.get_state()["generator"], draws["generator"])
    assert sharding_of(restored.model.params).spec == ("nodes", "model")
    assert sharding_of(restored.mailbox.sender).spec == (None, "nodes", None)
    for (p, a), (_, b) in zip(parallel.rules.named_leaves(st),
                              parallel.rules.named_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=p)
    _, rep_sh = run(sim_sh, restored, 2)
    np.testing.assert_allclose(rep_plain.curves(local=False)["accuracy"],
                               rep_sh.curves(local=False)["accuracy"],
                               rtol=1e-4, atol=1e-5)


def test_manifest_records_the_mesh(mesh):
    sim = build_fused(mesh)
    m = sim.run_manifest().to_dict()
    assert m["mesh"] == {"axis_names": ["nodes"], "shape": {"nodes": 8}}
    assert m["config"]["partition_rules"] == parallel.rules.rules_table()
    assert build().run_manifest().to_dict()["mesh"] is None


# -- the cohort ----------------------------------------------------------------

def cohort_sim(cohort=24, **kw):
    from gossipy_tpu_torch.simulation import CohortConfig
    h = SGDHandler(LogisticRegression(D, 2), losses.cross_entropy,
                   learning_rate=0.1, local_epochs=1, batch_size=8,
                   n_classes=2, input_shape=(D,))
    return GossipSimulator(
        h, tcore.Topology.random_regular(96, 6, seed=3), dataset(64),
        delta=20, cohort=CohortConfig(size=cohort), draws=TorchDraws(5),
        device="cpu", **kw)


def test_cohort_mesh_validation_and_placement(mesh):
    """``start(pool, n, mesh=)`` needs C divisible by the node axis; it
    places each segment's [C] state and rows and changes nothing else;
    ``GossipSimulator(cohort=, mesh=)`` runs the [C] round's deliver as
    the ring (the unsharded run up to reassociation)."""
    from gossipy_tpu_torch.simulation import cohort as tcohort
    sim = cohort_sim()
    with pytest.raises(ValueError, match="not divisible"):
        sim.start(sim.init_cohort_pool(), n_rounds=1,
                  mesh=make_mesh(5, devices=["cpu"] * 5))
    placed = []
    real = parallel.shard_state

    def spy(state, m, *a, **k):
        placed.append(state.model.params.shape[0])
        return real(state, m, *a, **k)

    pool0 = cohort_sim().init_cohort_pool()
    want, rep = cohort_sim().start(pool0, n_rounds=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(parallel, "shard_state", spy)
        got, rep_m = cohort_sim().start(pool0, n_rounds=4, mesh=mesh)
    assert placed == [24] * 4
    for a, b in zip(tcohort._leaves(want.model), tcohort._leaves(got.model)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rep.sent_per_round, rep_m.sent_per_round)
    ring, rep_r = cohort_sim(mesh=mesh).start(pool0, n_rounds=4)
    np.testing.assert_allclose(ring.model.params, want.model.params,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(rep.sent_per_round, rep_r.sent_per_round)
    fp = tcohort._mesh_fingerprint(mesh)
    assert fp == tcohort._mesh_fingerprint(make_mesh(8, devices=["cpu"] * 8))
    assert fp != tcohort._mesh_fingerprint(make_mesh(4, devices=["cpu"] * 4))
    assert tcohort._mesh_fingerprint(None) is None


# -- the service -----------------------------------------------------------------

def test_service_mesh_bucket_equals_solo_runs(tmp_path, mesh):
    """Two tenants served on a mesh: each lane is its solo run on the same
    mesh bit for bit, and the solo run without a mesh up to the ring's
    reassociation."""
    from gossipy_tpu_torch.config import ExperimentConfig, run_experiment
    from gossipy_tpu_torch.service import GossipService, RunQueue, RunRequest
    from gossipy_tpu_torch.telemetry.metrics import MetricsRegistry

    rng = np.random.default_rng(1)
    X = rng.normal(size=(240, 8)).astype(np.float32)
    y = (X @ rng.normal(size=8) > 0).astype(np.int64)
    cfgs = {t: ExperimentConfig(
        n_nodes=16, model="logreg", topology="random_regular",
        topology_params={"degree": 4}, n_rounds=4, delta=10, eval_every=2,
        seed=seed, batch_size=8, simulator_params={"sentinels": True})
        for t, seed in (("alice", 1), ("bob", 2))}
    svc = GossipService(str(tmp_path), slice_rounds=2, events_jsonl=False,
                        mesh=mesh, registry=MetricsRegistry(), device="cpu")
    q = RunQueue()
    handles = {t: q.submit(RunRequest(t, c, data=(X, y)))
               for t, c in cfgs.items()}
    svc.serve(q)
    for t, cfg in cfgs.items():
        rep = handles[t].report
        _, solo = run_experiment(cfg, data=(X, y), device="cpu", mesh=mesh)
        assert json.dumps(rep.to_dict(), sort_keys=True) == \
            json.dumps(solo.to_dict(), sort_keys=True)
        _, flat = run_experiment(cfg, data=(X, y), device="cpu")
        np.testing.assert_allclose(rep.curves(local=False)["accuracy"],
                                   flat.curves(local=False)["accuracy"],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(rep.sent_per_round,
                                      flat.sent_per_round)


# -- the JAX package's mesh runs, under the draw oracle -------------------------

@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    return jparallel.make_mesh(8)


@pytest.mark.parametrize("wire", ["float32", "int8"])
def test_mesh_run_matches_jax_mesh_run(mesh, jmesh, wire):
    """``GossipSimulator(mesh=)`` in both packages, 16 nodes on 8
    positions, the same JAX init, the port drawing through the oracle:
    accounting exact, params within 1e-5 (plus an encoding step on the
    int8 ring)."""
    key = jax.random.PRNGKey(3)
    n = 16
    adj = np.ones((n, n), dtype=bool)
    data = small_data(n=n)
    jh, th = logreg()
    kw = dict(delta=100, fused_merge="multi", mailbox_slots=4,
              history_dtype=wire)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=r"mailbox_slots=")
        jsim = jsimulation.GossipSimulator(
            jh, jcore.Topology(adj), jparallel.shard_data(data, jmesh),
            mesh=jmesh, **kw)
        tsim = GossipSimulator(th, tcore.Topology(adj), data, mesh=mesh,
                               draws=JaxDraws(key, init_key=key),
                               device="cpu", **kw)
    jst = jsim.init_nodes(key, common_init=True)
    tst = shard_state(to_port_state(tsim, jst), mesh)
    jst, jrep = jsim.start(jparallel.shard_state(jst, jmesh), n_rounds=6,
                           key=key, donate_state=False)
    tst, trep = tsim.start(tst, n_rounds=6)
    assert jrep.sent_messages > 0
    assert_same_run(jsim, tsim, jst, tst, jrep, trep)


def test_all2all_ring_matches_jax_ring(mesh, jmesh):
    """``All2AllGossipSimulator(mesh=, ring_mix=True)`` in both packages
    under the oracle."""
    key = jax.random.PRNGKey(4)
    topo = tcore.Topology.random_regular(16, 4, seed=0)
    data = small_data(n=16)
    jh, th = logreg("weighted")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jtopo = jcore.Topology(topo.adjacency)
        jsim = jsimulation.All2AllGossipSimulator(
            jh, jtopo, jparallel.shard_data(data, jmesh), delta=100,
            mixing=jcore.uniform_mixing(jtopo), mesh=jmesh, ring_mix=True)
        tsim = All2AllGossipSimulator(
            th, topo, data, delta=100, mixing=tcore.uniform_mixing(topo),
            mesh=mesh, ring_mix=True, draws=JaxDraws(key, init_key=key),
            device="cpu")
    jst = jsim.init_nodes(key, common_init=True)
    tst = to_port_state(tsim, jst)
    jst, jrep = jsim.start(jparallel.shard_state(jst, jmesh), n_rounds=5,
                           key=key, donate_state=False)
    tst, trep = tsim.start(tst, n_rounds=5)
    assert jrep.sent_messages > 0
    assert_same_run(jsim, tsim, jst, tst, jrep, trep)


def test_sharded_merge_on_jax_ring_state_matches_jax(mesh, jmesh):
    """One deliver's sharded merge of a JAX mesh run's own ring and tables,
    in both packages, within 1e-6."""
    from gossipy_tpu.parallel import collectives as jcoll
    from gossipy_tpu_torch.parallel.collectives import \
        sharded_gather_merge_multi
    rng = np.random.default_rng(5)
    n, f, depth, k = 16, 22, 3, 5
    p = rng.normal(size=(n, f)).astype(np.float32)
    h = rng.normal(size=(depth, n, f)).astype(np.float32)
    idx = rng.integers(0, depth * n, size=(n, k))
    wp = np.where(rng.random((n, k)) < 0.5, 0.5, 0.0).astype(np.float32)
    ws = (1.0 - wp).astype(np.float32)
    want = jcoll.sharded_gather_merge_multi(
        {"w": jax.numpy.asarray(p)}, {"w": jax.numpy.asarray(h)},
        jax.numpy.asarray(idx.astype(np.int32)), jax.numpy.asarray(ws),
        jax.numpy.asarray(wp), jmesh)["w"]
    got = sharded_gather_merge_multi(
        torch.from_numpy(p), torch.from_numpy(h), torch.from_numpy(idx),
        torch.from_numpy(ws), torch.from_numpy(wp), mesh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
