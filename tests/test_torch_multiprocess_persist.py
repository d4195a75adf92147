"""Checkpoints, the flight recorder and host telemetry on a mesh across
processes: gloo ranks on the CPU (``parallel.init_distributed``, then
``make_mesh()`` over every rank's positions) run the north star's shape
at a small size (``test_torch_multiprocess_engine.py``'s 16 nodes,
``random_regular(16, 4)``, LogReg, the multi deliver), against the same
runs in one process, unsharded and on virtual meshes, and against the
JAX package's mesh run under the draw oracle.

Three spawns, each reaped after TIMEOUT_S:

- ``pair`` (2 ranks) runs :func:`pair_legs`:

  - ``save``: for each ring format (float32, bfloat16, and the examples'
    network model on an int8 ring), SAVE_AT rounds, ``sim.save``, MORE
    rounds; then a fresh simulator loads the ranks' file, the file the
    2-position virtual mesh run saved at the same round, and (float32)
    the unsharded run's, and runs MORE rounds from each;
  - ``manager``: ``CheckpointManager.run`` to round 6 in chunks of 3,
    then a fresh simulator's manager resumes from its newest file to
    round 9;
  - ``oracle``: under the JAX draw oracle, 3 rounds, a save, a fresh
    simulator's load and 3 more;
  - ``recorder``: sentinels on and a NaN written into node NAN_NODE (a
    row of rank 1) before round NAN_ROUND, under ``FlightRecorder(chunk=
    2)``;
  - ``host``: ``perf=``, ``metrics=``, ``ledger=`` and ``tracing=`` on
    at once.

- ``fail`` (2 ranks, at the same time) runs the recorder while rank 1
  raises in round FAIL_ROUND and rank 0 waits for it in the round's
  collectives.
- ``grid`` (4 ranks, after ``pair``) restores the pair's float32 file
  onto a ``(dcn, nodes)`` mesh, ``make_mesh_2d(4, 2)`` over two positions
  a rank, and runs MORE rounds.

A ring over the node axis sums a receiver's messages chunk by chunk
(``parallel.collectives.sharded_gather_merge_multi``: equal to the
unsharded fold up to float reassociation), so a run continues bit for
bit only on a mesh of the same shape: a resume is held bit-equal to the
run that continues the same file on the same layout, and within 1e-6 of
the uninterrupted run where the layout changes.
"""

import json
import os
import subprocess
import sys
import textwrap
import time
import warnings
from pathlib import Path

import jax
import pytest
import torch

from gossipy_tpu import core as jcore
from gossipy_tpu import parallel as jparallel
from gossipy_tpu import simulation as jsimulation
from gossipy_tpu_torch import core as tcore
from gossipy_tpu_torch import parallel
from gossipy_tpu_torch.checkpoint import CheckpointManager, draw_record
from gossipy_tpu_torch.handlers import SGDHandler, losses
from gossipy_tpu_torch.models import LogisticRegression
from gossipy_tpu_torch.parallel import rules
from gossipy_tpu_torch.random import TorchDraws
from gossipy_tpu_torch.simulation import GossipSimulator
from test_torch_multiprocess_engine import FEAT, N, NETWORK, dataset, \
    free_port, gathered, leaves, oracle_sim, reap, virtual

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 150
SAVE_AT, MORE = 5, 5
RINGS = {"float32": {}, "bfloat16": {"history_dtype": "bfloat16"},
         "int8": NETWORK}
NAN_NODE, NAN_ROUND, REC_ROUNDS = 11, 3, 8
FAIL_ROUND = 3
HOST_ROUNDS = 4
WORLD = {"pair": 2, "fail": 2, "grid": 4}
GROUP_TIMEOUT_S = {"pair": 90, "fail": 30, "grid": 90}

WORKER = textwrap.dedent("""
    import datetime, sys
    import torch
    sys.path.insert(0, {tests!r})
    import test_torch_multiprocess_persist as t
    from gossipy_tpu_torch import parallel
    rank, port, workdir, spawn = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                  sys.argv[4])
    parallel.init_distributed(
        f"localhost:{{port}}", t.WORLD[spawn], rank, device="cpu",
        timeout=datetime.timedelta(seconds=t.GROUP_TIMEOUT_S[spawn]))
    try:
        out = t.LEGS[spawn](t.rank_mesh(spawn), workdir)
        torch.save(out, f"{{workdir}}/{{spawn}}{{rank}}.pt")
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
""")


# -- the configurations, in both the ranks and the parent -----------------------

def ns(mesh, ring="float32", **kw):
    """The north star's shape at N = 16 on ``mesh`` (None: unsharded) on
    the ``ring`` format (the int8 ring with the network model), draws
    from ``TorchDraws(7)``: ``(sim, state)``, the state placed."""
    handler = SGDHandler(LogisticRegression(FEAT, 2), losses.cross_entropy,
                         learning_rate=0.1, local_epochs=1, batch_size=32,
                         n_classes=2, input_shape=(FEAT,),
                         create_model_mode=tcore.CreateModelMode.MERGE_UPDATE)
    data = dataset() if mesh is None else parallel.shard_data(dataset(),
                                                              mesh)
    kw = {"delta": 100, "protocol": tcore.AntiEntropyProtocol.PUSH,
          **RINGS[ring], **kw}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sim = GossipSimulator(handler, tcore.Topology.random_regular(
            N, 4, seed=0), data, fused_merge="multi", mesh=mesh,
            draws=TorchDraws(7), device="cpu", **kw)
    state = sim.init_nodes(torch.Generator().manual_seed(0))
    if mesh is not None:
        state = parallel.shard_state(state, mesh)
    return sim, state


def grid(devices):
    return parallel.make_mesh_2d(4, 2, devices=devices)


def rank_mesh(spawn):
    """The spawn's mesh across ranks: every rank's positions (two a rank
    for the grid, as the JAX test's processes each hold two devices)."""
    if spawn != "grid":
        return parallel.make_mesh(devices=parallel.devices("cpu"))
    return grid([parallel.Position(p.device, p.rank, 2 * p.id + j)
                 for p in parallel.devices("cpu") for j in range(2)])


def poison(sim, node, at):
    """Write a NaN into ``node``'s first parameter before round ``at``'s
    snapshot, on whichever process holds the node's row."""
    pre_send = sim._pre_send

    def hook(state, r):
        pre_send(state, r)
        rows = sim._rows or slice(0, sim.n_nodes)
        if r == at and rows.start <= node < rows.stop:
            state.model.params[node - rows.start, 0] = float("nan")
    sim._pre_send = hook


def host_leg(mesh, ledger):
    """HOST_ROUNDS rounds with every host option on, the metrics fed into
    a registry of their own."""
    from gossipy_tpu_torch.telemetry import MetricsRegistry, Tracer, metrics
    prev = metrics.set_registry(MetricsRegistry())
    try:
        tracer = Tracer()
        sim, state = ns(mesh, perf=True, metrics=True, ledger=ledger,
                        tracing=tracer)
        state, rep = sim.start(state, HOST_ROUNDS)
        snap = metrics.get_registry().snapshot()["metrics"]
    finally:
        metrics.set_registry(prev)
    return dict(perf=sim.perf_summary(), trace=tracer.snapshot(),
                metrics={k: v for k, v in snap.items()
                         if k.startswith("engine_")},
                manifest=sim.run_manifest().to_dict(), report=rep.to_dict(),
                leaves=leaves(state))


def recorder_leg(mesh, out_dir):
    from gossipy_tpu_torch.telemetry import FlightRecorder
    sim, state = ns(mesh, sentinels=True)
    poison(sim, NAN_NODE, NAN_ROUND)
    rec = FlightRecorder(out_dir, chunk=2)
    _, reports, bundle = rec.run(sim, state, REC_ROUNDS)
    return dict(bundle=bundle, chunks=len(reports), gathers=rec.gathers,
                listing=sorted(os.listdir(out_dir)))


def pair_legs(mesh, workdir) -> dict:
    """Every leg of the ``pair`` spawn on this rank."""
    from gossipy_tpu_torch.simulation import SimulationReport
    out = {"save": {}}
    for ring in RINGS:
        sim, state = ns(mesh, ring)
        state, _ = sim.start(state, SAVE_AT)
        sim.save(f"{workdir}/ranks-{ring}.pt", state)
        draws = draw_record(sim.draws)
        state, rep = sim.start(state, MORE)
        resumed = {}
        for src in ("ranks", "virtual") + (("unsharded",) if ring ==
                                            "float32" else ()):
            fresh, _ = ns(mesh, ring)
            st, _ = fresh.load(f"{workdir}/{src}-{ring}.pt")
            st, r2 = fresh.start(st, MORE)
            resumed[src] = dict(leaves=leaves(st), report=r2.to_dict())
        out["save"][ring] = dict(leaves=leaves(state), report=rep.to_dict(),
                                 draws=draws, resumed=resumed)
    sim, state = ns(mesh)
    CheckpointManager(f"{workdir}/mgr", interval=3, max_to_keep=2).run(
        sim, state, 6)
    sim, state = ns(mesh)
    mgr = CheckpointManager(f"{workdir}/mgr", interval=3, max_to_keep=2)
    reports: list = []
    st = mgr.run(sim, state, 9, reports=reports)
    out["manager"] = dict(leaves=leaves(st), round=int(st.round),
                          kept=mgr.checkpoints(),
                          rounds=[len(r.sent_per_round) for r in reports])
    init = torch.load(f"{workdir}/oracle_init.pt", weights_only=False)
    sim = oracle_sim(mesh)
    state = parallel.shard_state(sim.init_state(*init), mesh)
    state, rep1 = sim.start(state, 3)
    sim.save(f"{workdir}/oracle.pt", state)
    fresh = oracle_sim(mesh)
    st, draws = fresh.load(f"{workdir}/oracle.pt")
    st, rep2 = fresh.start(st, 3)
    out["oracle"] = dict(whole=gathered(st, mesh), draws=draws,
                         report=SimulationReport.concatenate([rep1, rep2]))
    out["recorder"] = recorder_leg(mesh, f"{workdir}/fr")
    out["host"] = host_leg(mesh, f"{workdir}/ledger.jsonl")
    return out


def fail_legs(mesh, workdir) -> dict:
    """The recorder while rank 1 raises in round FAIL_ROUND: never
    returns."""
    from gossipy_tpu_torch.telemetry import FlightRecorder
    sim, state = ns(mesh, sentinels=True)
    rank = torch.distributed.get_rank()
    pre_send = sim._pre_send

    def hook(st, r):
        pre_send(st, r)
        if r == FAIL_ROUND and rank == 1:
            raise RuntimeError("injected on rank 1")
    sim._pre_send = hook
    FlightRecorder(f"{workdir}/fail", chunk=2).run(sim, state, REC_ROUNDS)
    return {}


def grid_legs(mesh, workdir) -> dict:
    """The pair's float32 checkpoint restored onto the grid, MORE
    rounds."""
    sim, _ = ns(mesh)
    st, _ = sim.load(f"{workdir}/ranks-float32.pt")
    st, rep = sim.start(st, MORE)
    return dict(leaves=leaves(st), report=rep.to_dict(),
                rows=mesh.node_rows(N))


LEGS = {"pair": pair_legs, "fail": fail_legs, "grid": grid_legs}


# -- the parent -----------------------------------------------------------------

def spawn(name, workdir) -> list:
    port = free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), str(REPO / "tests")]), OMP_NUM_THREADS="1")
    script = WORKER.format(tests=str(REPO / "tests"))
    return [subprocess.Popen(
        [sys.executable, "-c", script, str(rank), str(port), str(workdir),
         name], cwd=workdir, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(WORLD[name])]


def load_ranks(workdir, name) -> list:
    return [torch.load(workdir / f"{name}{r}.pt", weights_only=False)
            for r in range(WORLD[name])]


def checked(procs, outs, name):
    for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{name} rank {rank}:\n{err[-4000:]}"


def run_from(sim, path, rounds):
    st, _ = sim.load(path)
    st, rep = sim.start(st, rounds)
    return leaves(st), rep.to_dict()


def jax_oracle_run(rounds):
    """The JAX engine's uninterrupted run on a 2-device mesh from its
    ``init_nodes`` state, and the port's initial state from it."""
    from torch_pairs import logreg, small_data, to_port_state
    jh, _ = logreg()
    key = jax.random.PRNGKey(3)
    adj = tcore.Topology.random_regular(N, 4, seed=0).adjacency
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jmesh = jparallel.make_mesh(2)
        jsim = jsimulation.GossipSimulator(
            jh, jcore.Topology(adj), jparallel.shard_data(small_data(n=N),
                                                          jmesh),
            delta=100, fused_merge="multi", mailbox_slots=4, mesh=jmesh)
    jst0 = jsim.init_nodes(key, common_init=True)
    tsim = oracle_sim(virtual())
    st0 = to_port_state(tsim, jst0)
    jst, jrep = jsim.start(jparallel.shard_state(jst0, jmesh),
                           n_rounds=rounds, key=key, donate_state=False)
    return (st0.model, st0.phase), (jsim, tsim, st0, jst, jrep)


@pytest.fixture(scope="module")
def persist(tmp_path_factory):
    """Save the one-process files the ranks load, start the ``pair`` and
    ``fail`` spawns, run the references while they run, then the
    ``grid`` spawn; returns ``(rank outputs by spawn, references, work
    directory, seconds by spawn)``."""
    workdir = tmp_path_factory.mktemp("persist")
    init, jax_side = jax_oracle_run(6)
    torch.save(init, workdir / "oracle_init.pt")
    for ring in RINGS:
        sim, state = ns(virtual(), ring)
        state, _ = sim.start(state, SAVE_AT)
        sim.save(str(workdir / f"virtual-{ring}.pt"), state)
    sim, state = ns(None)
    state, _ = sim.start(state, SAVE_AT)
    sim.save(str(workdir / "unsharded-float32.pt"), state)
    t0 = time.perf_counter()
    procs = {name: spawn(name, workdir) for name in ("pair", "fail")}
    refs = {"jax": jax_side}
    try:
        for ring in RINGS:
            sim, state = ns(virtual(), ring)
            state, rep = sim.start(state, SAVE_AT + MORE)
            refs[ring] = (leaves(state), rep.to_dict())
        refs["unsharded>virtual"] = run_from(
            ns(virtual())[0], str(workdir / "unsharded-float32.pt"), MORE)
        sim, state = ns(virtual())
        state, _ = sim.start(state, 9)
        refs["manager"] = leaves(state)
        refs["recorder"] = recorder_leg(virtual(), str(workdir / "fr-virt"))
        refs["host"] = host_leg(virtual(), str(workdir / "ledger-virt.jsonl"))
    finally:
        outs = {name: reap(p, TIMEOUT_S) for name, p in procs.items()}
    seconds = {name: time.perf_counter() - t0 for name in procs}
    checked(procs["pair"], outs["pair"], "pair")
    got = {"pair": load_ranks(workdir, "pair"),
           "fail": (procs["fail"], outs["fail"])}
    t0 = time.perf_counter()
    procs = spawn("grid", workdir)
    try:
        refs["grid"] = run_from(ns(grid(["cpu"] * 8))[0],
                                str(workdir / "ranks-float32.pt"), MORE)
    finally:
        outs = reap(procs, TIMEOUT_S)
    seconds["grid"] = time.perf_counter() - t0
    checked(procs, outs, "grid")
    got["grid"] = load_ranks(workdir, "grid")
    return got, refs, workdir, seconds


def rank_rows(x, path, rank, world=2):
    """Rank ``rank``'s rows of a whole leaf."""
    dim = 1 if path.startswith(("history", "mailbox", "reply_box")) else 0
    share = x.shape[dim] // world
    return x.narrow(dim, rank * share, share)


def assert_rows(mine: dict, whole: dict, rank: int, world=2, label=""):
    """Every leaf of a rank's state bit-equal to its rows of ``whole``."""
    assert sorted(mine) == sorted(whole), label
    for path, x in whole.items():
        torch.testing.assert_close(mine[path], rank_rows(x, path, rank,
                                                         world),
                                   rtol=0, atol=0,
                                   msg=f"{label} {path} r{rank}")


def same_json(a, b) -> bool:
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def saved(path):
    return torch.load(path, weights_only=True)


@pytest.mark.parametrize("ring", sorted(RINGS))
def test_save_equals_the_virtual_mesh_save(persist, ring):
    """Two ranks' ``sim.save`` at round SAVE_AT writes one file of the
    whole population, equal leaf for leaf (the ring in its wire format,
    an int8 ring's scales with it) and in its draw state to the file the
    2-position virtual mesh run saves at the same round."""
    _, _, workdir, _ = persist
    got = saved(workdir / f"ranks-{ring}.pt")
    want = saved(workdir / f"virtual-{ring}.pt")
    assert sorted(got["state"]) == sorted(want["state"])
    for k, v in want["state"].items():
        if isinstance(v, torch.Tensor):
            assert got["state"][k].dtype == v.dtype, k
            assert torch.equal(got["state"][k], v), k
        else:
            assert got["state"][k] == v, k
    assert got["state"]["model.params"].shape[0] == N
    if ring == "int8":
        assert got["state"]["history_scale"] is not None
    assert torch.equal(got["draws"]["state"]["generator"],
                       want["draws"]["state"]["generator"])
    assert not list(workdir.glob("*.tmp"))


def test_draw_states_equal_across_ranks(persist):
    """Every rank draws the whole round, so the ranks' draw states at the
    save are equal, and the file keeps that one state."""
    got, _, workdir, _ = persist
    for ring in RINGS:
        recs = [g["save"][ring]["draws"] for g in got["pair"]]
        file = saved(workdir / f"ranks-{ring}.pt")["draws"]
        for rec in recs:
            assert rec["kind"] == file["kind"] == "TorchDraws"
            assert torch.equal(rec["state"]["generator"],
                               file["state"]["generator"])


def test_save_matches_the_unsharded_save(persist):
    """The unsharded run's file at the same round: the same leaves,
    shapes, dtypes and draw state; the values within the ring's float
    reassociation."""
    _, _, workdir, _ = persist
    got = saved(workdir / "ranks-float32.pt")
    want = saved(workdir / "unsharded-float32.pt")
    assert sorted(got["state"]) == sorted(want["state"])
    for k, v in want["state"].items():
        if not isinstance(v, torch.Tensor):
            assert got["state"][k] == v, k
            continue
        assert got["state"][k].shape == v.shape, k
        assert got["state"][k].dtype == v.dtype, k
        if v.is_floating_point():
            torch.testing.assert_close(got["state"][k], v, rtol=0,
                                       atol=1e-6)
        else:
            assert torch.equal(got["state"][k], v), k
    assert torch.equal(got["draws"]["state"]["generator"],
                       want["draws"]["state"]["generator"])


@pytest.mark.parametrize("ring", sorted(RINGS))
def test_resume_across_ranks(persist, ring):
    """A fresh simulator on the ranks loads the ranks' file, and the one
    the one-process virtual mesh saved: MORE rounds from either equal
    the uninterrupted virtual mesh run's rows bit for bit, as do the
    uninterrupted ranks."""
    got, refs, _, _ = persist
    whole, report = refs[ring]
    for rank, mine in enumerate(got["pair"]):
        leg = mine["save"][ring]
        assert_rows(leg["leaves"], whole, rank, label=f"{ring} straight")
        assert same_json(leg["report"]["sent_per_round"],
                         report["sent_per_round"][SAVE_AT:])
        for src in ("ranks", "virtual"):
            res = leg["resumed"][src]
            assert_rows(res["leaves"], whole, rank, label=f"{ring} {src}")
            assert same_json(res["report"], leg["report"]), (ring, src)


def test_unsharded_checkpoint_resumes_across_ranks(persist):
    """One process's unsharded file restored onto the ranks continues as
    the same file does on the 2-position virtual mesh, bit for bit."""
    got, refs, _, _ = persist
    whole, report = refs["unsharded>virtual"]
    for rank, mine in enumerate(got["pair"]):
        res = mine["save"]["float32"]["resumed"]["unsharded"]
        assert_rows(res["leaves"], whole, rank, label="unsharded")
        assert same_json(res["report"], report)


@pytest.mark.parametrize("ring", sorted(RINGS))
def test_ranks_checkpoint_resumes_in_one_process(persist, ring):
    """The ranks' file in one process: on a 2-position virtual mesh MORE
    rounds equal the uninterrupted run bit for bit; unsharded they equal
    the unsharded continuation of the virtual mesh's file bit for bit,
    and the uninterrupted run within the reassociation."""
    _, refs, workdir, _ = persist
    whole, report = refs[ring]
    mine, rep = run_from(ns(virtual(), ring)[0],
                         str(workdir / f"ranks-{ring}.pt"), MORE)
    assert_rows(mine, whole, 0, world=1, label=ring)
    assert same_json(rep["sent_per_round"], report["sent_per_round"][SAVE_AT:])
    flat, flat_rep = run_from(ns(None, ring)[0],
                              str(workdir / f"ranks-{ring}.pt"), MORE)
    want, want_rep = run_from(ns(None, ring)[0],
                              str(workdir / f"virtual-{ring}.pt"), MORE)
    assert_rows(flat, want, 0, world=1, label=f"{ring} unsharded")
    assert same_json(flat_rep, want_rep)
    torch.testing.assert_close(flat["model/params"], whole["model/params"],
                               rtol=0, atol=1e-6)


def test_pair_checkpoint_resumes_on_the_grid(persist):
    """The pair's file restored onto four ranks of a ``(dcn, nodes)``
    mesh, two positions a rank: each rank keeps its four rows, and MORE
    rounds equal the same file's continuation on the 4 x 2 virtual mesh
    bit for bit (the uninterrupted 2-position run within the ring's
    reassociation)."""
    got, refs, _, _ = persist
    whole, report = refs["grid"]
    for rank, mine in enumerate(got["grid"]):
        assert mine["rows"] == slice(rank * N // 4, (rank + 1) * N // 4)
        assert_rows(mine["leaves"], whole, rank, world=4, label="grid")
        assert same_json(mine["report"], report)
    straight = refs["float32"][0]["model/params"]
    torch.testing.assert_close(whole["model/params"], straight, rtol=0,
                               atol=1e-6)


def test_checkpoint_manager_across_ranks(persist):
    """``CheckpointManager.run`` on the ranks: a second run resumes from
    the newest file (round 6), runs the 3 rounds left and keeps the
    newest two files; its rows equal the uninterrupted 9-round virtual
    mesh run's bit for bit."""
    got, refs, workdir, _ = persist
    for rank, mine in enumerate(got["pair"]):
        leg = mine["manager"]
        assert leg["round"] == 9 and leg["rounds"] == [3]
        assert leg["kept"] == [6, 9]
        assert_rows(leg["leaves"], refs["manager"], rank, label="manager")
    assert sorted(os.listdir(workdir / "mgr")) == ["round_00000006",
                                                    "round_00000009"]


def test_oracle_resume_matches_the_jax_mesh_run(persist):
    """Under the JAX draw oracle, 3 rounds on the ranks, a save, a fresh
    simulator's restore and 3 more rounds against the JAX engine's
    uninterrupted 6 rounds on a 2-device mesh: accounting exact, params
    and metrics within PERF.md section 2's 1e-5 (``test_load_into_tp_
    mesh``'s check, across ranks). The oracle keys its draws on the
    round, so the file keeps no draw state."""
    from torch_pairs import assert_same_run
    got, refs, _, _ = persist
    jsim, tsim, st0, jst, jrep = refs["jax"]
    for mine in got["pair"]:
        leg = mine["oracle"]
        assert leg["draws"] is None
        tst = rules.tree_map_with_path(
            lambda p, x: torch.as_tensor(leg["whole"][p])
            if isinstance(x, torch.Tensor) else x, st0)
        tst.round = 6
        assert_same_run(jsim, tsim, jst, tst, jrep, leg["report"])


def bundle_files(path) -> list:
    return sorted(os.listdir(path))


def test_recorder_bundle_across_ranks(persist):
    """The sentinel trips on both ranks in the same chunk: ONE bundle,
    written by rank 0, whose checkpoint (the whole population at the
    chunk's start, gathered once a chunk) and verdict equal the virtual
    mesh run's bundle's."""
    got, refs, _, _ = persist
    want = refs["recorder"]
    for mine in got["pair"]:
        leg = mine["recorder"]
        assert leg["listing"] == [os.path.basename(leg["bundle"])]
        assert leg["bundle"].endswith("bundle_r000002_sentinel")
        assert leg["chunks"] == want["chunks"] == 2
        assert leg["gathers"] == 2 and want["gathers"] == 0
    bundle = got["pair"][0]["recorder"]["bundle"]
    assert bundle_files(bundle) == bundle_files(want["bundle"]) == [
        "checkpoint", "checkpoint.meta.json", "events.jsonl",
        "manifest.json", "verdict.json"]
    a = saved(os.path.join(bundle, "checkpoint"))
    b = saved(os.path.join(want["bundle"], "checkpoint"))
    assert sorted(a["state"]) == sorted(b["state"])
    for k, v in b["state"].items():
        assert (torch.equal(a["state"][k], v) if isinstance(v, torch.Tensor)
                else a["state"][k] == v), k
    assert torch.equal(a["draws"]["state"]["generator"],
                       b["draws"]["state"]["generator"])
    va, vb = (json.load(open(os.path.join(p, "verdict.json")))
              for p in (bundle, want["bundle"]))
    assert va == vb and va["first_bad_round"] == NAN_ROUND
    manifest = json.load(open(os.path.join(bundle, "manifest.json")))
    assert manifest["backend"]["process_count"] == 2


def test_replay_of_a_bundle_written_across_ranks(persist):
    """``replay_bundle`` in one process, unsharded, on the ranks' bundle
    finds the first bad round, leaf and node that it finds on the virtual
    mesh run's bundle, the recorded one."""
    from gossipy_tpu_torch.telemetry import replay_bundle
    got, refs, _, _ = persist
    verdicts = []
    for bundle in (got["pair"][0]["recorder"]["bundle"],
                   refs["recorder"]["bundle"]):
        sim, _ = ns(None, sentinels=True)
        poison(sim, NAN_NODE, NAN_ROUND)
        verdicts.append(replay_bundle(bundle, sim))
    mine, want = verdicts
    assert mine["first_bad_round"] == want["first_bad_round"] == NAN_ROUND
    assert mine["matches_recorded"] is True
    assert mine["leaf"] == want["leaf"] and NAN_NODE in mine["nodes"]
    assert mine["phase"] == want["phase"] == "send"


def test_exception_on_one_rank(persist):
    """Rank 1 raises inside a chunk while rank 0 waits for it in the
    round's collectives: rank 1 writes its own bundle (the chunk's start
    state, whole, written without a collective) and re-raises; rank 0
    fails with an error, writing its own, and neither process hangs."""
    _, _, workdir, seconds = persist
    procs, outs = persist[0]["fail"]
    assert seconds["fail"] < TIMEOUT_S
    for rank, p in enumerate(procs):
        assert p.returncode == 1, (rank, p.returncode, outs[rank][1][-2000:])
    assert "injected on rank 1" in outs[1][1]
    names = sorted(os.listdir(workdir / "fail"))
    assert names == ["bundle_r000002_exception_rank0",
                     "bundle_r000002_exception_rank1"]
    for name in names:
        path = workdir / "fail" / name
        verdict = json.load(open(path / "verdict.json"))
        assert verdict["kind"] == "exception"
        assert verdict["chunk_start_round"] == 2
        state = saved(path / "checkpoint")["state"]
        assert state["model.params"].shape[0] == N and state["round"] == 2
    verdict = json.load(open(workdir / "fail" /
                             "bundle_r000002_exception_rank1" /
                             "verdict.json"))
    assert "injected on rank 1" in verdict["detail"]["error"]


def test_perf_across_ranks(persist):
    """``perf=`` on the ranks: the analytic cost of the whole population
    equal to the virtual mesh run's on every rank; the last run's time
    and MFU each rank's own (no peak on the CPU, so no MFU); the run
    equal to the virtual mesh's with every option on."""
    got, refs, _, _ = persist
    want = refs["host"]
    for rank, mine in enumerate(got["pair"]):
        perf = mine["host"]["perf"]
        assert perf["analytic"] == want["perf"]["analytic"]
        assert perf["analytic"]["flops_per_round"] > 0
        last = perf["last_run"]
        assert last["rounds"] == HOST_ROUNDS and last["seconds"] > 0
        assert last["mfu_est"] is None and perf["hbm_peak_bytes"] is None
        assert last["flops_per_round"] == want["perf"]["last_run"][
            "flops_per_round"]
        assert same_json(mine["host"]["report"]["sent_per_round"],
                         want["report"]["sent_per_round"])
        assert_rows(mine["host"]["leaves"], want["leaves"], rank,
                    label="host")


def test_metrics_across_ranks(persist):
    """``metrics=`` on the ranks: the population counters (rounds,
    messages, failures by cause) equal the virtual mesh run's on every
    rank."""
    got, refs, _, _ = persist
    want = refs["host"]["metrics"]
    assert sorted(want) == ["engine_messages_failed_total",
                            "engine_messages_sent_total",
                            "engine_rounds_total"]
    for mine in got["pair"]:
        assert same_json(mine["host"]["metrics"], want)


def test_ledger_rows_across_ranks(persist):
    """``ledger=`` on the ranks: one row a rank in one file, each saying
    which rank wrote it and how many there were."""
    from gossipy_tpu_torch.telemetry import RunLedger
    _, _, workdir, _ = persist
    rows = RunLedger(str(workdir / "ledger.jsonl")).rows()
    assert len(rows) == 2
    assert sorted(r["extra"]["process_index"] for r in rows) == [0, 1]
    assert all(r["extra"]["process_count"] == 2 for r in rows)
    assert all(r["extra"]["rounds"] == HOST_ROUNDS for r in rows)
    assert len({r["config_fingerprint"] for r in rows}) == 1


def test_traces_merge_across_ranks(persist):
    """``tracing=`` on the ranks: one trace a rank under its own pid;
    ``merge_traces`` joins them into one timeline holding both pids, each
    with its ``engine.start`` span."""
    from gossipy_tpu_torch.telemetry.tracing import merge_traces
    got, _, _, _ = persist
    traces = [mine["host"]["trace"] for mine in got["pair"]]
    pids = [{e["pid"] for e in t["traceEvents"]} for t in traces]
    assert all(len(p) == 1 for p in pids) and pids[0] != pids[1]
    merged = merge_traces(*traces)
    assert merged["otherData"]["merged_pids"] == sorted(pids[0] | pids[1])
    for pid in pids:
        assert any(e.get("name") == "engine.start" and e["pid"] in pid
                   for e in merged["traceEvents"])


def test_manifest_process_count(persist):
    """The run manifest's process count is the process group's world size
    across ranks (with this rank's index) and 1 in one process, as
    ``jax.process_count()`` gives it there."""
    from gossipy_tpu.telemetry import manifest as jmanifest
    got, refs, _, _ = persist
    for rank, mine in enumerate(got["pair"]):
        backend = mine["host"]["manifest"]["backend"]
        assert backend["process_count"] == 2
        assert backend["process_index"] == rank
    one = refs["host"]["manifest"]["backend"]
    assert one["process_count"] == 1 == jmanifest._backend_info()[
        "process_count"]
    assert one["process_index"] == 0
