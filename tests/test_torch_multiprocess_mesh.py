"""The JAX package's multi-controller legs across ranks
(``tests/test_multihost.py``): gloo ranks on the CPU, each owning
several positions of one device, run ``GossipSimulator(mesh=)`` on

- ``tp``: a ``(nodes, model)`` mesh, ``make_mesh_tp(4, 2)`` over two
  ranks of 4 positions each (every model-axis row within one rank), the
  JAX test's DP x TP leg: 16 nodes, 8 features, ``MLP(8, 2,
  hidden_dims=(16,))``, SGD 0.5, batch 8, PUSH, 2 rounds;
- ``grid``: a ``(dcn, nodes)`` mesh, ``make_mesh_2d(4, 2)`` over four
  ranks of 2 positions each (the node axis is the flattened pair, so the
  ring crosses all three rank boundaries), the JAX test's LogReg leg, 10
  rounds.

Each leg runs under the JAX draw oracle from the JAX engine's
``init_nodes`` state. Every rank's rows of every leaf and its whole report
equal the 8-position virtual mesh run's bit for bit, and the run matches
the JAX engine's run on the same mesh shape (8 virtual CPU devices in
one process): accounting and boxes exact, params and metrics within
1e-5 (``torch_pairs.assert_same_run``). The grid leg learns (final
accuracy above 0.8, as the JAX test asks).

The ranks of both legs start together and are reaped after TIMEOUT_S.
"""

import json
import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from gossipy_tpu import core as jcore
from gossipy_tpu import parallel as jparallel
from gossipy_tpu import simulation as jsimulation
from gossipy_tpu.data import ClassificationDataHandler, DataDispatcher
from gossipy_tpu.handlers import SGDHandler, losses
from gossipy_tpu.models import MLP, LogisticRegression
from gossipy_tpu_torch import core as tcore
from gossipy_tpu_torch import handlers as th
from gossipy_tpu_torch import models as tmodels
from gossipy_tpu_torch import parallel
from gossipy_tpu_torch.optim import sgd
from gossipy_tpu_torch.parallel import rules
from gossipy_tpu_torch.simulation import GossipSimulator
from test_torch_multiprocess_engine import free_port, gathered, leaves, reap

REPO = Path(__file__).resolve().parents[1]
N, FEAT, POSITIONS = 16, 8, 8
TIMEOUT_S = 150

# leg -> (ranks, model, rounds, init seed, run seed), as the JAX test runs
# it.
LEGS = {"tp": (2, "mlp", 2, 2, 3), "grid": (4, "logreg", 10, 0, 1)}

WORKER = textwrap.dedent("""
    import datetime, sys
    import torch
    sys.path.insert(0, {tests!r})
    import test_torch_multiprocess_mesh as t
    from gossipy_tpu_torch import parallel
    leg, rank, port, workdir = (sys.argv[1], int(sys.argv[2]), sys.argv[3],
                                sys.argv[4])
    world = t.LEGS[leg][0]
    parallel.init_distributed(f"localhost:{{port}}", world, rank,
                              device="cpu",
                              timeout=datetime.timedelta(seconds=90))
    try:
        out = t.run_leg(leg, t.rank_mesh(leg, world), workdir)
        torch.save(out, f"{{workdir}}/{{leg}}-rank{{rank}}.pt")
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
""")


def make(leg, devices):
    """The leg's mesh over ``devices`` (8 positions)."""
    if leg == "tp":
        return parallel.make_mesh_tp(4, 2, devices=devices)
    return parallel.make_mesh_2d(4, 2, devices=devices)


def rank_mesh(leg, world):
    """The leg's mesh across ranks: each rank's device as POSITIONS /
    world positions of its own, as the JAX test's processes each hold
    several virtual devices."""
    per = POSITIONS // world
    return make(leg, [parallel.Position(p.device, p.rank, per * p.id + j)
                      for p in parallel.devices("cpu") for j in range(per)])


def virtual(leg):
    return make(leg, ["cpu"] * POSITIONS)


def jax_mesh(leg):
    if leg == "tp":
        return jparallel.make_mesh_tp(4, 2)
    return jparallel.make_mesh_2d(4, 2)


def dataset():
    """The JAX test's data: 16 nodes of a separable 8-feature set."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=FEAT)
    X = rng.normal(size=(N * 12, FEAT)).astype(np.float32)
    y = (X @ w > 0).astype(np.int64)
    return DataDispatcher(ClassificationDataHandler(X, y, test_size=0.25),
                          n=N).stacked()


def handlers(model):
    """The leg's handler in both packages: SGD 0.5, batch 8, one epoch."""
    common = dict(local_epochs=1, batch_size=8, n_classes=2,
                  input_shape=(FEAT,),
                  create_model_mode=tcore.CreateModelMode.MERGE_UPDATE)
    if model == "mlp":
        jm, tm = MLP(FEAT, 2, hidden_dims=(16,)), tmodels.MLP(
            FEAT, 2, hidden_dims=(16,))
    else:
        jm, tm = LogisticRegression(FEAT, 2), tmodels.LogisticRegression(
            FEAT, 2)
    jh = SGDHandler(model=jm, loss=losses.cross_entropy,
                    optimizer=optax.sgd(0.5), **common)
    return jh, th.SGDHandler(tm, th.losses.cross_entropy,
                             optimizer=sgd(0.5), **common)


def port_sim(leg, mesh, data):
    """The leg on ``mesh`` under the oracle's draws of the run's key."""
    from torch_oracle import JaxDraws
    _, model, _, _, run_seed = LEGS[leg]
    _, thd = handlers(model)
    return GossipSimulator(
        thd, tcore.Topology.random_regular(N, 4, seed=0),
        parallel.shard_data(data, mesh), delta=8,
        protocol=tcore.AntiEntropyProtocol.PUSH, fused_merge="multi",
        mesh=mesh, draws=JaxDraws(jax.random.PRNGKey(run_seed)),
        device="cpu")


def run_leg(leg, mesh, workdir) -> dict:
    """The leg on ``mesh`` from the saved initial state: this process's
    rows of every leaf, the whole state (gathered) and the report."""
    inputs = torch.load(f"{workdir}/inputs.pt", weights_only=False)
    sim = port_sim(leg, mesh, inputs["data"])
    state = parallel.shard_state(sim.init_state(*inputs[leg]), mesh)
    placed = parallel.sharding_of(state.model.params)
    state, rep = sim.start(state, n_rounds=LEGS[leg][2])
    return dict(leaves=leaves(state), whole=gathered(state, mesh),
                report=rep.to_dict(), run=rep, shape=mesh.shape,
                rows=mesh.node_rows(N), spec=tuple(placed.spec),
                global_shape=placed.global_shape)


def spawn(leg, port, workdir) -> list:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), str(REPO / "tests")]), OMP_NUM_THREADS="1")
    script = WORKER.format(tests=str(REPO / "tests"))
    return [subprocess.Popen(
        [sys.executable, "-c", script, leg, str(rank), str(port),
         str(workdir)], cwd=workdir, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(LEGS[leg][0])]


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """Start both legs' ranks, run the virtual mesh and JAX references
    while they run, and return ``{leg: (rank outputs, references)}``."""
    from torch_pairs import to_port_state
    workdir = tmp_path_factory.mktemp("mesh-ranks")
    data = dataset()
    inputs, jax_side = {"data": data}, {}
    for leg, (_, model, _, init_seed, _) in LEGS.items():
        jh, _ = handlers(model)
        jmesh = jax_mesh(leg)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jsim = jsimulation.GossipSimulator(
                jh, jcore.Topology.random_regular(N, 4, seed=0),
                jparallel.shard_data(data, jmesh), delta=8,
                protocol=jcore.AntiEntropyProtocol.PUSH,
                fused_merge="multi", mesh=jmesh)
        jst0 = jsim.init_nodes(jax.random.PRNGKey(init_seed))
        tsim = port_sim(leg, virtual(leg), data)
        st0 = to_port_state(tsim, jst0)
        inputs[leg] = (st0.model, st0.phase)
        jax_side[leg] = (jsim, jmesh, jst0, tsim, st0)
    torch.save(inputs, workdir / "inputs.pt")
    procs = {leg: spawn(leg, free_port(), workdir) for leg in LEGS}
    try:
        refs = {}
        for leg, (jsim, jmesh, jst0, tsim, st0) in jax_side.items():
            rounds, run_seed = LEGS[leg][2], LEGS[leg][4]
            vsim = port_sim(leg, virtual(leg), data)
            vst, vrep = vsim.start(parallel.shard_state(
                vsim.init_state(st0.model, st0.phase), virtual(leg)),
                n_rounds=rounds)
            jst, jrep = jsim.start(jparallel.shard_state(jst0, jmesh),
                                   n_rounds=rounds,
                                   key=jax.random.PRNGKey(run_seed),
                                   donate_state=False)
            refs[leg] = dict(leaves=leaves(vst), report=vrep.to_dict(),
                             jax=(jsim, tsim, st0, jst, jrep))
    finally:
        outs = {leg: reap(p, TIMEOUT_S) for leg, p in procs.items()}
    got = {}
    for leg, ps in procs.items():
        for rank, (p, (_, err)) in enumerate(zip(ps, outs[leg])):
            assert p.returncode == 0, f"{leg} rank {rank}:\n{err[-4000:]}"
        got[leg] = [torch.load(workdir / f"{leg}-rank{r}.pt",
                               weights_only=False)
                    for r in range(len(ps))]
    return {leg: (got[leg], refs[leg]) for leg in LEGS}


def rank_rows(x: torch.Tensor, path: str, rank: int, world: int):
    """Rank ``rank``'s rows of a whole leaf of the virtual mesh run."""
    dim = 1 if path.startswith(("history", "mailbox", "reply_box")) else 0
    share = x.shape[dim] // world
    return x.narrow(dim, rank * share, share)


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_ranks_equal_the_virtual_mesh_run(legs, leg):
    """Every rank reports the virtual mesh run's report and holds its
    rows of every leaf bit for bit (its contiguous run of the node axis:
    two node positions of the TP mesh, or one ``dcn`` row of the 2-D
    mesh)."""
    got, ref = legs[leg]
    world = LEGS[leg][0]
    for rank, mine in enumerate(got):
        assert mine["shape"] == dict(virtual(leg).shape)
        assert mine["rows"] == slice(rank * N // world,
                                     (rank + 1) * N // world)
        assert json.dumps(mine["report"], sort_keys=True) == \
            json.dumps(ref["report"], sort_keys=True), (leg, rank)
        assert sorted(mine["leaves"]) == sorted(ref["leaves"])
        for path, x in ref["leaves"].items():
            torch.testing.assert_close(mine["leaves"][path],
                                       rank_rows(x, path, rank, world),
                                       rtol=0, atol=0,
                                       msg=f"{leg} {path} r{rank}")
    assert sum(got[0]["report"]["sent_per_round"]) > 0


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_placement_across_ranks(legs, leg):
    """Every rank records its params' placement as the virtual mesh
    resolves it (the model axis on the row's columns of the TP mesh, the
    flattened ``(dcn, nodes)`` pair on the 2-D mesh's node dimension),
    with the whole leaf's shape."""
    got, _ = legs[leg]
    rows = torch.zeros(N, got[0]["leaves"]["model/params"].shape[1])
    want = parallel.state_shardings(
        {"model": {"params": rows}}, virtual(leg))["model"]["params"]
    assert tuple(want.spec) == ({"tp": ("nodes", "model"),
                                 "grid": (("dcn", "nodes"), None)}[leg])
    for mine in got:
        assert mine["spec"] == tuple(want.spec)
        assert mine["global_shape"] == tuple(rows.shape)


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_ranks_match_the_jax_mesh_run(legs, leg):
    """Under the oracle, every rank's whole state (gathered) and report
    against the JAX engine's run on the same mesh shape: accounting
    exact, params and metrics within 1e-5."""
    from torch_pairs import assert_same_run
    got, ref = legs[leg]
    jsim, tsim, st0, jst, jrep = ref["jax"]
    assert jrep.sent_messages > 0
    for mine in got:
        whole = mine["whole"]
        tst = rules.tree_map_with_path(
            lambda p, x: torch.as_tensor(whole[p])
            if isinstance(x, torch.Tensor) else x, st0)
        tst.round = LEGS[leg][2]
        assert_same_run(jsim, tsim, jst, tst, jrep, mine["run"])


def test_grid_leg_learns(legs):
    """The four ranks' 2-D run learns, as the JAX test asks of its own:
    every rank sees the same curve, ending above 0.8."""
    got, _ = legs["grid"]
    curves = [mine["report"]["global_evals"] for mine in got]
    assert all(c == curves[0] for c in curves)
    names = got[0]["report"]["metric_names"]
    acc = [row[names.index("accuracy")] for row in curves[0]]
    assert np.isfinite(acc).all() and acc[-1] > 0.8, acc
