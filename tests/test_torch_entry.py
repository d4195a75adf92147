"""The contract entry twin (``gossipy_tpu_torch/entry.py``) against
``__graft_entry__.py`` on the CPU.

- ``entry``: the port's forward step gives finite ``[8, 10]`` logits, and
  on the JAX ``entry()``'s own weights (converted) and a numpy-seeded
  batch it equals the JAX forward step within 1e-5 of the largest logit.
- Each dryrun leg for n = 2 and 4 against the same block of
  ``dryrun_multichip`` in the JAX package, on the conftest's virtual CPU
  devices (``make_mesh(2)``, ``make_mesh_tp(2, 2)``), the port drawing
  through the JAX draw oracle from the JAX leg's converted ``init_nodes``
  state: sent, failed by cause and both boxes exact, params within
  ``MESH_TOL`` (1e-5 + 1e-4 of the value), the accuracy within 1e-4; the
  ring's plain and flash forms within 1e-5 of the JAX ``ring_attention``.
  The port's default deliver is ``"multi"`` (K1) where the JAX file's is
  the plain one, and under MERGE_UPDATE the two paths apply different
  updates in either package (``multi`` folds a node's messages into one
  update), so the JAX block runs with ``fused_merge="multi"``: the path
  the port's leg takes.
- ``dryrun_multichip(n, device="cpu")`` end to end, and no run without a
  card unless the host is asked for.
"""

import subprocess
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gossipy_tpu import core as jcore
from gossipy_tpu import parallel as jparallel
from gossipy_tpu.data import ClassificationDataHandler, DataDispatcher
from gossipy_tpu.handlers import SGDHandler, WeightedSGDHandler, losses
from gossipy_tpu.models import MLP
from gossipy_tpu.parallel.collectives import ring_attention
from gossipy_tpu.simulation import All2AllGossipSimulator, GossipSimulator
from gossipy_tpu_torch import entry as tentry
from gossipy_tpu_torch.convert import flatten_names, params_from_jax, \
    params_to_numpy
from gossipy_tpu_torch.models import CIFAR10Net
from gossipy_tpu_torch.models.nn import ParamLayout
from gossipy_tpu_torch.parallel import sharding_of
from torch_oracle import JaxDraws
from torch_pairs import assert_same_accounting, to_port_state

torch.set_num_threads(1)
MESH_TOL = (1e-5, 1e-4)     # (abs, rel), chip_smoke.py's phase 18
ACC_TOL = 1e-4
LOGIT_TOL = 1e-5
NS = (2, 4)


@pytest.fixture
def graft(monkeypatch):
    """``__graft_entry__`` with its backend probe stubbed healthy (the
    test process is pinned to the CPU already)."""
    import __graft_entry__ as g
    monkeypatch.setattr(
        subprocess, "run",
        lambda *a, **k: subprocess.CompletedProcess(a, returncode=0))
    return g


# -- entry ------------------------------------------------------------------

def test_entry_gives_finite_logits_on_the_host():
    fn, (params, x) = tentry.entry(device="cpu")
    out = fn(params, x)
    assert out.shape == (8, 10) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    assert x.shape == (8, 32, 32, 3) and not bool(x.any())
    assert sorted(params) == sorted(n for n, _ in CIFAR10Net().leaves)
    again = tentry.entry(device="cpu")[1][0]
    for k in params:
        torch.testing.assert_close(params[k], again[k], rtol=0, atol=0)


def test_entry_matches_the_jax_entry(graft):
    """On the JAX ``entry()``'s weights and a numpy-seeded batch, the two
    forward steps agree within 1e-5 of the largest logit."""
    jfn, (jparams, _) = graft.entry()
    fn, _ = tentry.entry(device="cpu")
    layout = ParamLayout(CIFAR10Net().leaves)
    flat = params_from_jax(jax.tree.map(np.asarray, jparams), layout,
                           stacked=False)
    x = np.random.default_rng(7).normal(size=(8, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(jfn)(jparams, jnp.asarray(x)))
    got = fn(layout.views(flat), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (8, 10)
    scale = float(np.abs(want).max())
    assert scale > 0
    assert float(np.abs(got - want).max()) <= LOGIT_TOL * scale


def test_entry_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.dryrun_multichip(2)


# -- the dryrun's legs against the JAX blocks ------------------------------

def jax_mesh(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual CPU devices")
    if n >= 4 and n % 2 == 0:
        return jparallel.make_mesh_tp(n // 2, 2)
    return jparallel.make_mesh(n)


def jax_data(n_nodes, jmesh):
    """``__graft_entry__.py``'s dataset and dispatcher."""
    d, n_samples = 8, 16 * n_nodes
    rng = np.random.default_rng(0)
    w = rng.normal(size=d)
    X = rng.normal(size=(n_samples, d)).astype(np.float32)
    y = (X @ w > 0).astype(np.int64)
    disp = DataDispatcher(ClassificationDataHandler(X, y, test_size=0.25),
                          n=n_nodes)
    return jparallel.shard_data(disp.stacked(), jmesh)


def jax_handler(weighted=False):
    cls = WeightedSGDHandler if weighted else SGDHandler
    kw = {"create_model_mode": jcore.CreateModelMode.MERGE_UPDATE} \
        if weighted else {}
    return cls(model=MLP(8, 2, hidden_dims=(16,)), loss=losses.cross_entropy,
               optimizer=optax.sgd(0.1), local_epochs=1, batch_size=8,
               n_classes=2, input_shape=(8,), **kw)


def jax_sim(leg, n_nodes, data, jmesh):
    """The JAX block's simulator on the port's deliver path, with its init
    and round keys."""
    if leg == "main":
        return GossipSimulator(
            jax_handler(), jcore.Topology.clique(n_nodes), data, delta=10,
            protocol=jcore.AntiEntropyProtocol.PUSH_PULL,
            delay=jcore.UniformDelay(0, 15),
            compact_deliver=max(8, n_nodes // 4), fused_merge="multi"), 0, 1
    if leg == "sparse":
        return GossipSimulator(
            jax_handler(), jcore.SparseTopology.ring(n_nodes, k=2), data,
            delta=10, protocol=jcore.AntiEntropyProtocol.PUSH,
            fused_merge="multi"), 3, 4
    topo = jcore.Topology.random_regular(n_nodes, 4, seed=0)
    return All2AllGossipSimulator(
        jax_handler(weighted=True), topo, data, delta=10,
        mixing=jcore.uniform_mixing(topo), mesh=jmesh, ring_mix=True), 5, 6


PORT_LEGS = {"main": tentry.main_leg, "sparse": tentry.sparse_leg,
             "all2all": tentry.all2all_leg}


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("leg", sorted(PORT_LEGS))
def test_leg_matches_the_jax_block(leg, n):
    jmesh = jax_mesh(n)
    setup = tentry.dryrun_setup(n, device="cpu")
    assert setup.n_nodes == 4 * n
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsim, init_seed, round_seed = jax_sim(leg, setup.n_nodes,
                                              jax_data(setup.n_nodes, jmesh),
                                              jmesh)
        jst0 = jsim.init_nodes(jax.random.PRNGKey(init_seed))
        jst, jrep = jsim.start(jparallel.shard_state(jst0, jmesh),
                               n_rounds=1, key=jax.random.PRNGKey(round_seed),
                               donate_state=False)
        got = PORT_LEGS[leg](setup, draws=JaxDraws(
            jax.random.PRNGKey(round_seed)),
            init_state=lambda tsim: to_port_state(tsim, jst0))
    assert jrep.sent_messages > 0
    if leg != "all2all":
        assert got.sim.fused_merge == "multi"
    assert_same_accounting(jsim, got.sim, jst, got.state, jrep, got.report)
    params = params_to_numpy(got.state.model.params, got.sim.handler.layout)
    for k, v in flatten_names(jst.model.params).items():
        want = np.asarray(v)
        tol = MESH_TOL[0] + MESH_TOL[1] * np.abs(want)
        assert (np.abs(params[k] - want) <= tol).all(), (
            k, float(np.abs(params[k] - want).max()))
    want_acc = float(jrep.curves(local=False)["accuracy"][-1])
    assert abs(got.accuracy - want_acc) <= ACC_TOL
    # The main and sparse legs' deliver is K1 (its plain version here).
    assert bool(got.entries.get("gather_merge_multi")) == (leg != "all2all")
    assert got.launches == {}


@pytest.mark.parametrize("n", NS)
def test_ring_leg_matches_jax_ring_attention(n):
    """Both forms of the port's ring within 1e-5 of the JAX ring's, both
    of the JAX forms too (its flash hop in Pallas interpret mode)."""
    jmesh = jax_mesh(n)
    s_len, dim = 8 * n, 16
    qkv = jax.random.normal(jax.random.PRNGKey(2), (3, s_len, dim),
                            dtype=jnp.float32)
    with jmesh:
        want = np.asarray(jax.jit(lambda q, k, v: ring_attention(
            q, k, v, jmesh, axis_name=None, causal=True))(*qkv))
        want_fl = np.asarray(jax.jit(lambda q, k, v: ring_attention(
            q, k, v, jmesh, axis_name=None, causal=True, flash=True))(*qkv))
    setup = tentry.dryrun_setup(n, device="cpu")
    got = tentry.ring_leg(setup, torch.from_numpy(np.array(qkv)))
    assert got.flash.shape == got.plain.shape == (s_len, dim)
    for w in (want, want_fl):
        np.testing.assert_allclose(got.plain.numpy(), w, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.flash.numpy(), w, rtol=0, atol=1e-5)
    assert got.max_diff <= tentry.RING_ATOL
    # A ring over the node axis: d hops at each of its d positions.
    d = n // 2 if n >= 4 else n
    assert got.entries == {"flash_hop": d * d}


# -- the whole dryrun ------------------------------------------------------

@pytest.mark.parametrize("n", NS)
def test_dryrun_runs_end_to_end_on_the_host(n, capsys):
    out = tentry.dryrun_multichip(n, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"dryrun_multichip OK: virtual mesh of {n} "
                           "positions on cpu ")
    assert out["n_nodes"] == 4 * n and out["device"] == "cpu"
    assert out["mesh"] == ({"nodes": 2, "model": 2} if n == 4
                           else {"nodes": 2})
    assert all(np.isfinite(a) for a in out["accuracy"].values())
    assert out["ring_max_diff"] <= tentry.RING_ATOL
    assert set(out["launches"]) == {"main", "ring", "sparse", "all2all"}
    assert not any(out["launches"].values())     # nothing launches here
    assert out["entries"]["main"]["gather_merge_multi"] == 2  # + replies
    assert out["entries"]["sparse"]["gather_merge_multi"] == 1
    assert out["entries"]["all2all"] == {}


@pytest.mark.parametrize("n,shape", [(1, {"nodes": 1}), (3, {"nodes": 3}),
                                     (4, {"nodes": 2, "model": 2}),
                                     (6, {"nodes": 3, "model": 2})])
def test_dryrun_mesh_is_the_jax_files(n, shape):
    """An even n >= 4 is a (n / 2) x 2 TP mesh, any other n a 1-D node
    mesh, every position the one device."""
    mesh = tentry.dryrun_mesh(n, torch.device("cpu"))
    assert mesh.shape == shape and mesh.is_virtual()
    assert {str(p.device) for p in mesh.positions} == {"cpu"}


def test_main_leg_state_is_placed_on_the_tp_mesh():
    """The data is placed on the mesh (per-node arrays over the node axis,
    the eval set replicated), and the main leg places its round-0 state
    (params over nodes and model) before the round."""
    from gossipy_tpu_torch import parallel
    setup = tentry.dryrun_setup(4, device="cpu")
    assert tuple(sharding_of(setup.data["xtr"]).spec) == ("nodes", None,
                                                          None)
    assert tuple(sharding_of(setup.data["x_eval"]).spec) == (None, None)
    placed = []
    real = parallel.shard_state

    def spy(state, mesh, *a, **k):
        out = real(state, mesh, *a, **k)
        placed.append((mesh, sharding_of(out.model.params).spec))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(parallel, "shard_state", spy)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            leg = tentry.main_leg(setup)
    assert [(m, tuple(spec)) for m, spec in placed] == [
        (setup.mesh, ("nodes", "model"))]
    assert leg.report.sent_messages > 0
