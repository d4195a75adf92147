"""A disk-backed cohort pool (``CohortConfig(pool_dir=)``) on a mesh across
processes: two gloo ranks on the CPU run ``GossipSimulator(cohort=...,
mesh=)`` with the pool in sparse files, against the same runs in one
process on a 2-position virtual mesh and against the JAX package's
``cohort_start(..., mesh=make_mesh(2))`` with a disk pool.

Each rank keeps its own replica of the store: rank 0's is ``pool_dir``
itself, rank ``r``'s ``<pool_dir>.rank<r>`` (``cohort.rank_pool_dir``).
One spawn of two ranks runs every leg (``run_legs``), at
``tests/test_torch_cohort.py``'s sizes (nominal 96, C = 24, 6 features,
``random_regular(96, 6)``, the multi deliver, ``TorchDraws(7)``):

- ``serial``: a fresh store, ROUNDS ``start`` calls of one round each,
  the store read after every one; ``stream``: a fresh store, the same
  rounds in one call with ``prefetch=2``; ``rpc2``: two rounds a cohort
  with ``prefetch=2``;
- ``save``: the serial pool checkpointed across the ranks (rank 0
  writes it), loaded into each rank's own work directory and continued
  MORE rounds; ``resume``: the serial store re-opened in place and
  continued the same rounds;
- ``layout``: a store written by one process, continued on the two
  ranks (rank 1 makes its replica from rank 0's files); after the
  spawn, the ranks' serial store continued in one process;
- ``stale``: rank 1's replica is at another round than rank 0's store;
  ``unseen``: rank 1 cannot see rank 0's store; both refused on every
  rank with ``ValueError``;
- ``oracle``: under the JAX draw oracle, ROUNDS rounds against the JAX
  disk pool's run on a 2-device mesh.

Held: every rank's reports and store (the rows where ``inited`` is set,
``inited``, ``touched``, ``phase``, ``node_key`` and the manifest's
round) bit-equal to the virtual mesh run's after every segment, the
replicas equal, ``prefetch=2`` equal to serial, a row trained in rank
1's share and later gathered into rank 0's keeping its trained values,
no file written by both ranks, and under the oracle the JAX run's ids,
accounting, coverage and active width exactly (the lazy rows are each
package's own, so params are held against the port's one-process run).
The spawn is reaped after TIMEOUT_S.
"""

import json
import os
import shutil
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from gossipy_tpu_torch.random import TorchDraws
from gossipy_tpu_torch.simulation import CohortConfig, GossipSimulator
from gossipy_tpu_torch.simulation import cohort as tcohort
from test_torch_cohort import handlers, make_data
from test_torch_multiprocess_cohort import oracle_draws, topologies
from test_torch_multiprocess_engine import free_port, reap, virtual
from test_torch_multiprocess_service import Writes

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120
NOMINAL, C = 96, 24
ROUNDS, MORE = 12, 4
ONE_PROCESS_ROUNDS = 4      # the layout leg's store, written by one process

WORKER = textwrap.dedent("""
    import datetime, sys
    import torch
    sys.path.insert(0, {tests!r})
    import test_torch_multiprocess_pool as t
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


# -- the configuration, in both the ranks and the parent -------------------------

def port_sim(mesh, pool_dir, draws=None, rpc=1, prefetch=0):
    """The cohort simulator on ``mesh`` (the ring deliver over the
    cohort's rows), its pool in ``pool_dir``, drawing from ``draws``
    (default ``TorchDraws(7)``)."""
    _, th = handlers()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return GossipSimulator(
            th, topologies("serial")[1], make_data(64), delta=20,
            fused_merge="multi", mesh=mesh,
            cohort=CohortConfig(size=C, rounds_per_cohort=rpc,
                                prefetch=prefetch, pool_dir=pool_dir),
            draws=TorchDraws(7) if draws is None else draws, device="cpu")


def store_view(sim) -> dict:
    """What the simulator's store holds: ``inited``, ``touched`` and every
    row leaf (model leaves, ``phase``, ``node_key``) whole, the rows
    never initialized zero (holes), and the round its manifest on disk
    names."""
    store = sim._pool_store
    with open(os.path.join(store.path, "pool_manifest.json")) as f:
        rnd = json.load(f)["round"]
    return {"round": rnd, "inited": np.array(store.inited, bool),
            "touched": np.array(store.touched),
            "leaves": [np.array(l) for l in tcohort._leaves(store.model)]
            + [np.array(store.phase), np.array(store.node_key)]}


def same_store(a: dict, b: dict) -> bool:
    """Two views agree: round, masks, and every leaf on the rows where
    ``inited`` is set (the rest are holes on both)."""
    on = a["inited"]
    return (a["round"] == b["round"] and np.array_equal(on, b["inited"])
            and np.array_equal(a["touched"], b["touched"])
            and all(np.array_equal(x[on], y[on])
                    for x, y in zip(a["leaves"], b["leaves"])))


def schedule(rounds=ROUNDS) -> list:
    """The serial leg's cohorts, round by round (sorted ids)."""
    material = TorchDraws(7).cohort_seed_material()
    return [tcohort.sample_cohort(material, r, NOMINAL, C)
            for r in range(rounds)]


def hazard_rows() -> list:
    """Every ``(row, r1, r2)``: a row first sampled at round ``r1`` into
    rank 1's half of the cohort, and first sampled into rank 0's half at
    ``r2``, later."""
    cohorts, out = schedule(), []
    for row in range(NOMINAL):
        halves = [(r, int(row in c[C // 2:])) for r, c in enumerate(cohorts)
                  if row in c]
        to_rank0 = [r for r, half in halves if half == 0]
        if halves and halves[0][1] == 1 and to_rank0:
            out.append((row, halves[0][0], to_rank0[0]))
    return out


def refused(fn) -> str:
    """``fn``'s exception and message (a leg that must raise)."""
    try:
        fn()
    except Exception as e:      # the outcome is reported, not raised
        return f"{type(e).__name__}: {e}"
    return "ok"


def run_legs(mesh, workdir) -> dict:
    """Every leg on ``mesh``: each one's reports and store views."""
    across = mesh.spans_ranks()
    tag = "ranks" if across else "virtual"
    writes = Writes(workdir) if across else None
    if writes is not None:
        writes.on = True
    out = {}

    def run(sim, pool, rounds):
        pool, rep = sim.start(pool, n_rounds=rounds, mesh=mesh)
        return pool, rep.to_dict()

    # serial: one round a call, the store read after each
    sim = port_sim(mesh, f"{workdir}/{tag}-serial")
    pool = sim.init_cohort_pool(torch.Generator().manual_seed(0))
    views, reports = [store_view(sim)], []
    for _ in range(ROUNDS):
        pool, rep = run(sim, pool, 1)
        views.append(store_view(sim))
        reports.append(rep)
    after = sim.draws.get_state()
    out["serial"] = dict(views=views, reports=reports)
    rows = np.array([row for row, _, _ in hazard_rows()], np.int64)
    out["hazard_init"] = sim._pool_store._rows(sim, rows)[0][0]
    for leg, rpc in (("stream", 1), ("rpc2", 2)):
        s = port_sim(mesh, f"{workdir}/{tag}-{leg}", rpc=rpc, prefetch=2)
        _, rep = run(s, s.init_cohort_pool(torch.Generator().manual_seed(0)),
                     ROUNDS)
        out[leg] = dict(views=[store_view(s)], reports=[rep])

    # save: checkpoint the serial pool, load it, continue
    path = sim.save(f"{workdir}/{tag}-ckpt", pool)
    s = port_sim(mesh, f"{workdir}/{tag}-serial", prefetch=2)
    loaded, _ = s.load(path)
    opened = store_view(s)
    _, rep = run(s, loaded, MORE)
    out["save"] = dict(views=[opened, store_view(s)], reports=[rep],
                       path=path, live=s._pool_store.path)
    # resume: re-open the serial store in place, continue
    s = port_sim(mesh, f"{workdir}/{tag}-serial", prefetch=2)
    s.draws.set_state(after)
    pool = s.init_cohort_pool(torch.Generator().manual_seed(0))
    opened = store_view(s)
    _, rep = run(s, pool, MORE)
    out["resume"] = dict(views=[opened, store_view(s)], reports=[rep])
    # layout: a store one process wrote, continued here
    s = port_sim(mesh, f"{workdir}/layout-{tag}", prefetch=2)
    s.draws.set_state(torch.load(f"{workdir}/layout-draws.pt",
                                 weights_only=False))
    pool = s.init_cohort_pool(torch.Generator().manual_seed(0))
    opened = store_view(s)
    _, rep = run(s, pool, MORE)
    out["layout"] = dict(views=[opened, store_view(s)], reports=[rep],
                         path=s._pool_store.path)
    # oracle: the JAX draw oracle's rounds
    s = port_sim(mesh, f"{workdir}/{tag}-oracle", draws=oracle_draws())
    _, rep = s.start(s.init_cohort_pool(), n_rounds=ROUNDS, mesh=mesh)
    out["oracle"] = dict(views=[store_view(s)], reports=[rep.to_dict()],
                         run=rep)
    if across:
        out["writes"] = sorted({path for _, path in writes.seen})
        # stale: rank 1's replica at another round than rank 0's store
        out["stale"] = refused(lambda: port_sim(
            mesh, f"{workdir}/stale").init_cohort_pool())
        # unseen: rank 1 cannot see rank 0's store
        first = tcohort.rank_pool_dir(f"{workdir}/unseen", 0)
        seen = tcohort.is_pool_store_dir
        if torch.distributed.get_rank() == 1:
            tcohort.is_pool_store_dir = lambda p: p != first and seen(p)
        try:
            out["unseen"] = refused(lambda: port_sim(
                mesh, f"{workdir}/unseen").init_cohort_pool())
        finally:
            tcohort.is_pool_store_dir = seen
    return out


# -- the parent -----------------------------------------------------------------

def spawn(workdir: Path) -> list:
    import subprocess
    port = free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), str(REPO / "tests")]), OMP_NUM_THREADS="1")
    script = WORKER.format(tests=str(REPO / "tests"))
    return [subprocess.Popen(
        [sys.executable, "-c", script, str(rank), str(port), str(workdir)],
        cwd=workdir, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in (0, 1)]


def one_process_stores(workdir: Path) -> None:
    """The stores the spawn opens, written by one process: the layout
    leg's (ONE_PROCESS_ROUNDS rounds, with a copy for the virtual mesh
    and the draw state after it), the stale pair (rank 0's store at round
    2, a rank-1 replica at round 4) and the unseen leg's."""
    def fresh(path, rounds):
        sim = port_sim(None, str(workdir / path))
        pool = sim.init_cohort_pool(torch.Generator().manual_seed(0))
        if rounds:
            sim.start(pool, n_rounds=rounds)
        return sim
    sim = fresh("layout-ranks", ONE_PROCESS_ROUNDS)
    torch.save(sim.draws.get_state(), workdir / "layout-draws.pt")
    shutil.copytree(workdir / "layout-ranks", workdir / "layout-virtual")
    fresh("stale", 2)
    fresh("stale.rank1", 4)
    fresh("unseen", 0)


def jax_oracle_run(path: str):
    """The JAX package's disk-pool run on a 2-device mesh under the
    oracle's key: ``(pool, report)``."""
    import jax
    from gossipy_tpu import parallel as jparallel
    from gossipy_tpu.core import AntiEntropyProtocol
    from gossipy_tpu.simulation import CohortConfig as JCohortConfig
    from gossipy_tpu.simulation import GossipSimulator as JGossipSimulator
    jh, _ = handlers()
    key = jax.random.PRNGKey(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsim = JGossipSimulator(
            jh, topologies("serial")[0], make_data(64), delta=20,
            protocol=AntiEntropyProtocol.PUSH, fused_merge="multi",
            cohort=JCohortConfig(size=C, pool_dir=path))
    return jsim.start(jsim.init_cohort_pool(key), n_rounds=ROUNDS, key=key,
                      mesh=jparallel.make_mesh(2))


def continued(workdir: Path, store: str) -> tuple:
    """``store`` (a path under ``workdir``) opened in one process on a
    2-position virtual mesh and continued MORE rounds: its views before
    and after, and the report."""
    sim = port_sim(virtual(), str(workdir / store), prefetch=2)
    pool = sim.init_cohort_pool(torch.Generator().manual_seed(0))
    opened = store_view(sim)
    _, rep = sim.start(pool, n_rounds=MORE, mesh=virtual())
    return opened, store_view(sim), rep.to_dict()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the two ranks, run the virtual mesh's legs and the JAX mesh
    run while they run, then continue the ranks' serial store in one
    process; returns ``(rank outputs, references, workdir)``."""
    workdir = tmp_path_factory.mktemp("pool-ranks")
    one_process_stores(workdir)
    procs = spawn(workdir)
    try:
        refs = run_legs(virtual(), str(workdir))
        jpool, jrep = jax_oracle_run(str(workdir / "jax-oracle"))
        refs["jax"] = dict(touched=np.array(jpool.touched), report=jrep)
    finally:
        outs = reap(procs, TIMEOUT_S)
    for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{err[-4000:]}"
    got = [torch.load(workdir / f"rank{r}.pt", weights_only=False)
           for r in (0, 1)]
    # The two-rank store (rank 0's replica) and the virtual mesh's, each
    # continued in one process.
    refs["two-rank store"] = continued(workdir, "ranks-serial")
    refs["virtual store"] = continued(workdir, "virtual-serial")
    return got, refs, workdir


LEGS = ("serial", "stream", "rpc2", "save", "resume", "layout", "oracle")


@pytest.mark.parametrize("leg", LEGS)
def test_ranks_equal_the_virtual_mesh_run(ranks, leg):
    """Every rank's reports and store, after every segment, bit-equal to
    the 2-position virtual mesh run's: the replicas are equal."""
    got, refs, _ = ranks
    want = refs[leg]
    for rank in (0, 1):
        mine = got[rank][leg]
        assert mine["reports"] == want["reports"], rank
        assert len(mine["views"]) == len(want["views"])
        for i, (a, b) in enumerate(zip(mine["views"], want["views"])):
            assert same_store(a, b), (rank, i)
    assert want["views"][-1]["touched"].any()
    assert want["views"][-1]["round"] > 0


def test_prefetch_equals_serial(ranks):
    """On each rank the ``prefetch=2`` store after ROUNDS rounds equals
    the serial store (ROUNDS calls of one round), and the resumed store
    equals the one continued from the checkpoint."""
    got, _, _ = ranks
    for rank in (0, 1):
        mine = got[rank]
        assert same_store(mine["stream"]["views"][-1],
                          mine["serial"]["views"][-1]), rank
        assert mine["resume"]["views"][-1]["round"] == ROUNDS + MORE
        assert same_store(mine["resume"]["views"][-1],
                          mine["save"]["views"][-1]), rank
        assert mine["resume"]["reports"] == mine["save"]["reports"], rank


def test_trained_row_survives_its_move_to_rank_0(ranks):
    """A row first trained in rank 1's half of a cohort, and later
    gathered into rank 0's half, keeps its trained values on rank 0: rank
    0 initialized it with the whole cohort, before rank 1's outputs were
    scattered over it, so no later lazy init overwrites them."""
    got, refs, _ = ranks
    views = [got[rank]["serial"]["views"] for rank in (0, 1)]
    # The rows rank 1 trained away from their lazy init before rank 0
    # first gathered them (at r2).
    moved = [(row, r1, r2) for (row, r1, r2), init in zip(
        hazard_rows(), got[0]["hazard_init"])
        if not np.array_equal(views[0][r2]["leaves"][0][row], init)]
    assert moved
    for row, r1, r2 in moved:
        for rank in (0, 1):
            assert views[rank][r1 + 1]["inited"][row], (rank, row)
            for r in range(r1 + 1, ROUNDS + 1):
                want = refs["serial"]["views"][r]["leaves"][0][row]
                assert np.array_equal(views[rank][r]["leaves"][0][row],
                                      want), (rank, row, r)


def test_layouts(ranks):
    """A store written by one process continues on two ranks (rank 1
    copies rank 0's files into its replica, holes kept), and a two-rank
    store continues in one process, each bit-equal to the same rounds on
    the virtual mesh."""
    got, refs, workdir = ranks
    for rank in (0, 1):
        mine = got[rank]["layout"]
        assert mine["path"] == tcohort.rank_pool_dir(
            str(workdir / "layout-ranks"), rank)
        assert mine["views"][0]["round"] == ONE_PROCESS_ROUNDS
    assert same_store(got[1]["layout"]["views"][0],
                      got[0]["layout"]["views"][0])
    a, b = refs["two-rank store"], refs["virtual store"]
    assert a[0]["round"] == ROUNDS + MORE
    assert same_store(a[0], b[0]) and same_store(a[1], b[1])
    assert a[2] == b[2]


def test_checkpoint_across_ranks(ranks):
    """``save`` writes the one checkpoint from rank 0's replica; ``load``
    copies it into each rank's own work directory."""
    got, refs, workdir = ranks
    ckpt = str(workdir / "ranks-ckpt")
    for rank in (0, 1):
        assert got[rank]["save"]["path"] == ckpt
        assert got[rank]["save"]["live"] == tcohort.rank_pool_dir(
            ckpt + ".live", rank)
        assert got[rank]["save"]["views"][0]["round"] == ROUNDS
    assert os.path.isfile(os.path.join(ckpt, "draws.pt"))
    assert not any(p.startswith(ckpt + os.sep) for p in got[1]["writes"])
    assert any(p.startswith(ckpt + os.sep) for p in got[0]["writes"])


def test_ranks_never_write_one_file(ranks):
    """Given the same ``pool_dir``, the two ranks of one host write
    disjoint files: each its own replica (and rank 0 the checkpoint)."""
    got, _, workdir = ranks
    w0, w1 = set(got[0]["writes"]), set(got[1]["writes"])
    assert w0 and w1 and not w0 & w1
    assert any(p.startswith(str(workdir / "ranks-serial.rank1") + os.sep)
               for p in w1)
    assert not any(".rank1" in p for p in w0)


def test_disagreeing_replicas_are_refused(ranks):
    """A replica whose manifest names another round than rank 0's store,
    and a rank 0 store that rank 1 cannot see, raise ``ValueError`` on
    both ranks, naming the paths: neither is used."""
    got, _, workdir = ranks
    stale = str(workdir / "stale")
    for rank in (0, 1):
        msg = got[rank]["stale"]
        assert msg.startswith("ValueError") and "disagrees" in msg, msg
        assert repr(stale + ".rank1") in msg and repr(stale) in msg, msg
    msg = got[1]["unseen"]
    assert msg.startswith("ValueError") and "cannot see" in msg, msg
    assert repr(str(workdir / "unseen")) in msg, msg
    assert got[0]["unseen"].startswith("ValueError") and \
        "failed on rank 1" in got[0]["unseen"], got[0]["unseen"]


def test_ranks_match_the_jax_mesh_run(ranks):
    """Under the JAX draw oracle, each rank against the JAX disk pool's
    run on ``make_mesh(2)``: the cohort ids (the touched mask), sent and
    failed by cause a round, coverage and active width exactly."""
    got, refs, _ = ranks
    jrep = refs["jax"]["report"]
    for rank in (0, 1):
        mine = got[rank]["oracle"]
        rep = mine["run"]
        assert np.array_equal(mine["views"][-1]["touched"],
                              refs["jax"]["touched"]), rank
        for field in ("sent_per_round", "failed_per_round",
                      "cohort_active_nodes", "cohort_coverage"):
            np.testing.assert_array_equal(getattr(rep, field),
                                          getattr(jrep, field),
                                          err_msg=field)
        for cause in ("drop", "offline", "overflow"):
            np.testing.assert_array_equal(rep.failed_per_cause[cause],
                                          jrep.failed_per_cause[cause])
    assert jrep.sent_messages > 0
