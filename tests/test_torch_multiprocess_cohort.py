"""A cohort's ``start(mesh=)`` on a mesh across processes: two gloo ranks
on the CPU (``parallel.init_distributed``, then ``make_mesh()`` over
every rank's positions) run active-cohort rounds with
``GossipSimulator(cohort=..., mesh=)``, against the same runs in one
process on a 2-position virtual mesh and against the JAX package's
``cohort_start(..., mesh=make_mesh(2))``.

Every rank holds the whole pool and stages its rows of each cohort; the
durable outputs are gathered whole and every rank scatters them into its
own pool. One spawn of two ranks runs every leg (``run_legs``), at
``tests/test_torch_cohort.py``'s sizes (nominal 96, C = 24, 6 features,
``random_regular(96, 6)``, the multi deliver):

- ``serial``, ``stream`` and ``rpc2``: under the JAX draw oracle from the
  JAX ``init_cohort_pool`` result, 8 rounds serially, with ``prefetch=2``
  and with ``rounds_per_cohort=2`` and ``prefetch=2``;
- ``induced``: the induced subgraph of a sparse ring (nominal 64, C = 32)
  under the oracle, 6 rounds;
- ``own``: the port's own draws (``TorchDraws``), each rank's pool from
  the same generator, ``rounds_per_cohort=2``: SEGMENTS ``start`` calls
  of one segment each, the pool's digest after each, then the same
  rounds in one ``start`` with ``prefetch=2``;
- ``save``: the ``own`` pool saved across the ranks (rank 0 writes the
  one file) and loaded back on each.

Held: every rank's pool and report bit-equal to the virtual mesh run's,
the ranks' pools equal after every segment, ``prefetch=2`` equal to
serial, and under the oracle the JAX mesh run's ids, accounting,
coverage and active width exactly, params and metrics within 1e-5.
The spawn is reaped after TIMEOUT_S.
"""

import hashlib
import textwrap
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gossipy_tpu import parallel as jparallel
from gossipy_tpu.core import AntiEntropyProtocol, SparseTopology, Topology
from gossipy_tpu.simulation import CohortConfig as JCohortConfig
from gossipy_tpu.simulation import GossipSimulator as JGossipSimulator
from gossipy_tpu_torch import core as tcore
from gossipy_tpu_torch import parallel
from gossipy_tpu_torch.random import TorchDraws
from gossipy_tpu_torch.simulation import CohortConfig, CohortPool, \
    GossipSimulator
from test_torch_cohort import assert_same_pool, assert_same_report, \
    handlers, make_data, port_pool
from test_torch_multiprocess_engine import free_port, reap, virtual
from torch_oracle import JaxDraws

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120
ROUNDS, INDUCED_ROUNDS = 8, 6
SEGMENTS = 4
# leg -> (nominal, C, rounds_per_cohort, prefetch, peer mode, rounds)
ORACLE_LEGS = {"serial": (96, 24, 1, 0, "resample", ROUNDS),
               "stream": (96, 24, 1, 2, "resample", ROUNDS),
               "rpc2": (96, 24, 2, 2, "resample", ROUNDS),
               "induced": (64, 32, 1, 0, "induced", INDUCED_ROUNDS)}

WORKER = textwrap.dedent("""
    import datetime, sys
    import torch
    sys.path.insert(0, {tests!r})
    import test_torch_multiprocess_cohort as t
    from gossipy_tpu_torch import parallel
    rank, port, workdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    parallel.init_distributed(
        f"localhost:{{port}}", 2, rank, device="cpu",
        timeout=datetime.timedelta(seconds=90))
    try:
        mesh = parallel.make_mesh(devices=parallel.devices("cpu"))
        out = t.run_legs(mesh, workdir)
        torch.save(out, f"{{workdir}}/rank{{rank}}.pt")
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
""")


# -- the configurations, in both the ranks and the parent -----------------------

def topologies(leg):
    """The leg's topology in both packages: ``random_regular(96, 6)``, or
    a sparse ring of 64 for the induced leg."""
    nominal = ORACLE_LEGS.get(leg, ORACLE_LEGS["serial"])[0]
    if leg == "induced":
        return SparseTopology.ring(nominal), tcore.SparseTopology.ring(
            nominal)
    jtopo = Topology.random_regular(nominal, 6, seed=3)
    return jtopo, tcore.Topology(np.asarray(jtopo.adjacency))


def port_sim(mesh, leg, draws):
    """The port's cohort simulator of ``leg`` on ``mesh`` (the ring
    deliver over the cohort's rows), drawing from ``draws``."""
    _, c, rpc, prefetch, mode, _ = ORACLE_LEGS.get(
        leg, (96, 24, 2, 2 if leg == "own-stream" else 0, "resample", 0))
    _, th = handlers()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return GossipSimulator(
            th, topologies(leg)[1], make_data(64),
            delta=20, fused_merge="multi", mesh=mesh,
            cohort=CohortConfig(size=c, rounds_per_cohort=rpc,
                                prefetch=prefetch, peer_mode=mode),
            draws=draws, device="cpu")


def oracle_draws():
    key = jax.random.PRNGKey(0)
    return JaxDraws(key, init_key=key)


def digest(pool: CohortPool) -> str:
    """One hash of every leaf of the pool and its round."""
    h = hashlib.sha256(str(int(pool.round)).encode())
    for leaf in (pool.model.params, *pool.model.opt_state,
                 pool.model.n_updates, pool.phase, pool.node_key,
                 pool.touched):
        h.update(np.ascontiguousarray(leaf).tobytes())
    return h.hexdigest()


def run_legs(mesh, workdir) -> dict:
    """Every leg on ``mesh``: each one's pool and report."""
    out = {}
    for leg, (*_, rounds) in ORACLE_LEGS.items():
        pool0 = torch.load(f"{workdir}/pool-{leg}.pt", weights_only=False)
        sim = port_sim(mesh, leg, oracle_draws())
        pool, rep = sim.start(pool0, n_rounds=rounds, mesh=mesh)
        out[leg] = dict(pool=pool, report=rep.to_dict(), run=rep)
    sim = port_sim(mesh, "own", TorchDraws(7))
    pool = sim.init_cohort_pool(torch.Generator().manual_seed(0))
    after0 = sim.draws.get_state()
    pool0, digests = pool, [digest(pool)]
    for _ in range(SEGMENTS):
        pool, _ = sim.start(pool, n_rounds=2, mesh=mesh)
        digests.append(digest(pool))
    out["own"] = dict(pool=pool, digests=digests)
    stream = port_sim(mesh, "own-stream", TorchDraws(7))
    stream.draws.set_state(after0)
    spool, srep = stream.start(pool0, n_rounds=2 * SEGMENTS, mesh=mesh)
    out["own-stream"] = dict(pool=spool, report=srep.to_dict())
    tag = "" if mesh.spans_ranks() else "-virtual"
    path = sim.save(f"{workdir}/pool{tag}.ckpt", pool)
    loaded, _ = port_sim(mesh, "own", TorchDraws(7)).load(path)
    out["save"] = dict(path=path, digest=digest(loaded))
    return out


# -- the parent -----------------------------------------------------------------

def spawn(workdir: Path) -> list:
    import os
    import subprocess
    import sys
    port = free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), str(REPO / "tests")]), OMP_NUM_THREADS="1")
    script = WORKER.format(tests=str(REPO / "tests"))
    return [subprocess.Popen(
        [sys.executable, "-c", script, str(rank), str(port), str(workdir)],
        cwd=workdir, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in (0, 1)]


def jax_sim(leg):
    _, c, rpc, _, mode, _ = ORACLE_LEGS[leg]
    jh, _ = handlers()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JGossipSimulator(
            jh, topologies(leg)[0], make_data(64),
            delta=20, protocol=AntiEntropyProtocol.PUSH, fused_merge="multi",
            cohort=JCohortConfig(size=c, rounds_per_cohort=rpc,
                                 peer_mode=mode))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the two ranks, run the virtual mesh's legs and the JAX mesh
    runs while they run, and return ``(rank outputs, references)``."""
    workdir = tmp_path_factory.mktemp("cohort-ranks")
    key = jax.random.PRNGKey(0)
    refs, jpools = {}, {}
    for leg in ORACLE_LEGS:
        jsim = jax_sim(leg)
        jpools[leg] = jsim.init_cohort_pool(key)
        pool0 = port_pool(port_sim(None, leg, oracle_draws()), jpools[leg])
        torch.save(pool0, workdir / f"pool-{leg}.pt")
        refs[leg] = {"jsim": jsim}
    procs = spawn(workdir)
    try:
        virt = run_legs(virtual(), workdir)
        jmesh = jparallel.make_mesh(2)
        for leg, (*_, rounds) in ORACLE_LEGS.items():
            refs[leg].update(virtual=virt[leg], jax=refs[leg]["jsim"].start(
                jpools[leg], n_rounds=rounds, key=key, mesh=jmesh),
                tsim=port_sim(None, leg, oracle_draws()))
        for leg in ("own", "own-stream", "save"):
            refs[leg] = {"virtual": virt[leg]}
    finally:
        outs = reap(procs, TIMEOUT_S)
    for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{err[-4000:]}"
    got = [torch.load(workdir / f"rank{r}.pt", weights_only=False)
           for r in (0, 1)]
    return got, refs, workdir


def same_pool(a: CohortPool, b: CohortPool) -> bool:
    return digest(a) == digest(b)


@pytest.mark.parametrize("leg", list(ORACLE_LEGS) + ["own", "own-stream"])
def test_ranks_equal_the_virtual_mesh_run(ranks, leg):
    """Every rank's pool (every leaf, the touched mask and the round) and
    report are bit-equal to the 2-position virtual mesh run's."""
    got, refs, _ = ranks
    want = refs[leg]["virtual"]
    for rank in (0, 1):
        assert same_pool(got[rank][leg]["pool"], want["pool"]), rank
        if "report" in want:
            assert got[rank][leg]["report"] == want["report"], rank
    assert np.asarray(want["pool"].touched).any()


@pytest.mark.parametrize("leg", list(ORACLE_LEGS))
def test_ranks_match_the_jax_mesh_run(ranks, leg):
    """Under the JAX draw oracle, each rank's run against the JAX
    ``cohort_start(..., mesh=make_mesh(2))``: accounting, coverage,
    active width, ages, phases and the touched mask exactly; params and
    metrics within 1e-5."""
    got, refs, _ = ranks
    jp, jrep = refs[leg]["jax"]
    for rank in (0, 1):
        mine = got[rank][leg]
        assert_same_report(mine["run"], jrep)
        assert_same_pool(refs[leg]["tsim"], mine["pool"], jp)
    assert jrep.sent_messages > 0


def test_pools_agree_after_every_segment(ranks):
    """With the port's own draws, the ranks' pools are equal to each other
    and to the virtual mesh run's after every segment, and the
    ``prefetch=2`` run's pool after the same rounds equals the serial
    one's."""
    got, refs, _ = ranks
    want = refs["own"]["virtual"]["digests"]
    assert len(set(want)) == SEGMENTS + 1
    for rank in (0, 1):
        assert got[rank]["own"]["digests"] == want, rank
        assert digest(got[rank]["own-stream"]["pool"]) == want[-1], rank


def test_pool_checkpoint_across_ranks(ranks):
    """A RAM pool saved on a mesh across ranks: rank 0 writes the one
    file, every rank loads it back whole."""
    got, refs, workdir = ranks
    want = digest(refs["own"]["virtual"]["pool"])
    assert (workdir / "pool.ckpt").is_file()
    for rank in (0, 1):
        assert got[rank]["save"]["path"] == str(workdir / "pool.ckpt")
        assert got[rank]["save"]["digest"] == want, rank
