"""The gossip service on a mesh across processes: two gloo ranks on the
CPU (``parallel.init_distributed``, then ``make_mesh()`` over every
rank's positions) run ``GossipService(mesh=)``, each rank holding its
rows of every lane, against the same service in one process on a
2-position virtual mesh and against the JAX package's
``GossipService(mesh=make_mesh(2))``.

One spawn of two ranks runs both legs (``run_legs``), at
``tests/test_torch_service.py``'s sizes (16 nodes, degree 4, 8 synthetic
features, slices of SLICE rounds):

- ``serve``: tenants ``a``, ``b`` (poisoned: a sentinel evicts it) and
  ``c`` submitted at the start, ``d`` and ``e`` after the first slice, so
  admission runs twice. The ranks' clocks differ: rank 1's scheduler
  clock runs SKEW_S ahead and it waits DELAY_S before every cycle; it
  has ``d`` in its queue from the start (rank 0's queue decides: ``d``
  waits for the second cycle there too) and gets ``e`` from its caller
  one cycle after rank 0 does (it runs rank 0's request from the second
  cycle, and the caller's late submit returns that handle). Tenant
  ``f``'s build fails on rank 1 alone: it fails on both ranks. Every
  rank's writes under the output directory are recorded (audit
  events).
- ``oracle``: two clean fp32 tenants (ORACLE; the JAX service on a mesh
  cannot save a poisoned tenant's report, whose ``-inf`` JSON refuses,
  so eviction is held in ``serve`` against the virtual mesh), each lane
  from the JAX lane's initial state and drawing through ``JaxDraws``
  from its key.

Held: each tenant's status, rounds and report bit-equal on both ranks to
the virtual mesh service's, the same admissions and evictions on both
ranks, rank 0 alone writing the output directory while every rank
records the same artifact paths and returns the same summary, and under
the oracle every lane against the JAX lane (accounting, boxes and ages
exactly, params within 1e-5, accuracy within 2e-5). The spawn is reaped
after TIMEOUT_S.
"""

import json
import os
import sys
import textwrap
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gossipy_tpu import checkpoint as jcheckpoint
from gossipy_tpu import parallel as jparallel
from gossipy_tpu import service as jservice
from gossipy_tpu.telemetry.metrics import MetricsRegistry as JRegistry
from gossipy_tpu_torch import parallel
from gossipy_tpu_torch import service as tservice
from gossipy_tpu_torch.config import ExperimentConfig as TConfig
from gossipy_tpu_torch.service import scheduler as tscheduler
from gossipy_tpu_torch.telemetry.metrics import MetricsRegistry
from test_torch_multiprocess_engine import free_port, reap, virtual
from test_torch_service import base, request_pair, tenant_data
from torch_oracle import JaxDraws
from torch_pairs import assert_same_run, to_port_state

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120
SLICE = 2
SKEW_S, DELAY_S = 1000.0, 0.05
# tenant -> (config seed, data seed, poisoned)
FIRST = {"a": (1, 1, False), "b": (2, 2, True), "c": (3, 3, False)}
LATER = {"d": (4, 4, False), "e": (5, 5, False)}
BROKEN = "f"
# The oracle bucket: (tenant, config, data seed, poisoned).
ORACLE = (("good", base(seed=1), 1, False),
          ("drops", base(seed=2, drop_prob=0.1), 2, False))

WORKER = textwrap.dedent("""
    import datetime, sys
    import torch
    sys.path.insert(0, {tests!r})
    import test_torch_multiprocess_service as t
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


# -- the legs, in both the ranks and the parent ----------------------------------

def request(tenant, seeds):
    seed, data_seed, poison = seeds
    return tservice.RunRequest(tenant, TConfig(**base(seed=seed)),
                               data=tenant_data(data_seed, poison=poison))


class Writes:
    """The files and directories this process creates, writes or renames
    under ``root`` (Python's audit events), while active."""

    def __init__(self, root: str):
        self.root, self.seen, self.on = os.path.abspath(root), [], False
        sys.addaudithook(self._hook)

    def _hook(self, event, args):
        if not self.on or event not in ("open", "os.mkdir", "os.rename"):
            return
        path = os.fsdecode(args[0]) if isinstance(args[0], (str, bytes,
                                                            os.PathLike)) \
            else ""
        if not path.startswith(self.root):
            return
        if event == "open" and not (
                (isinstance(args[1], str) and set(args[1]) & set("wax+"))
                or args[2] & (os.O_WRONLY | os.O_RDWR)):
            return
        self.seen.append((event, path))


def serve_leg(mesh, out: str, skewed: bool) -> dict:
    """The ``serve`` leg on ``mesh``: each tenant's handle, the cycle that
    admitted it, each bucket's tenants, the summary and the writes under
    ``out``. ``skewed`` (rank 1 of the spawn) runs the other clock, holds
    ``d`` early, gets ``e`` one cycle after rank 0 and fails to build
    ``f``."""
    writes = Writes(out)
    svc = tservice.GossipService(out, slice_rounds=SLICE,
                                 registry=MetricsRegistry(), mesh=mesh,
                                 device="cpu")
    q = tservice.RunQueue()
    for t, seeds in FIRST.items():
        q.submit(request(t, seeds))
    across = mesh.spans_ranks()
    if across:
        q.submit(request(BROKEN, (6, 6, False)))
    if skewed:
        q.submit(request("d", LATER["d"]))
    sess = svc.session(q)
    admitted, cycle, late_e = {}, 0, None
    with pytest.MonkeyPatch.context() as mp:
        if skewed:
            now = time.time
            mp.setattr(tscheduler.time, "time", lambda: now() + SKEW_S)
            build = tscheduler.build_request

            def broken(req, **kw):
                if req.tenant == BROKEN:
                    raise RuntimeError("no data for f on this rank")
                return build(req, **kw)
            mp.setattr(tscheduler, "build_request", broken)
        writes.on = True
        while True:
            if skewed:
                time.sleep(DELAY_S)
            live = sess.poll()
            for rt in sess.runtimes:
                for t in rt.bucket.tenants:
                    admitted.setdefault(t, cycle)
            cycle += 1
            if cycle == 1:
                if not skewed:
                    for t, seeds in LATER.items():
                        q.submit(request(t, seeds))
                live = True
            if cycle == 2 and skewed:
                h = q.submit(request("e", LATER["e"]))
                late_e = dict(status=h.status.value, supplied=any(
                    h is run.handle for rt in sess.runtimes
                    for run in rt.bucket.runs))
            if not live:
                break
        summary = sess.finish()
        writes.on = False
    handles = {h.tenant: dict(status=h.status.value,
                              rounds=h.rounds_completed,
                              report=None if h.report is None
                              else h.report.to_dict(), error=h.error,
                              bundle=h.bundle_path,
                              artifacts=dict(h.artifacts))
               for h in q.handles()}
    return dict(handles=handles, admitted=admitted, summary=summary,
                buckets=[sorted(rt.bucket.tenants) for rt in sess.runtimes],
                writes=writes.seen, late_e=late_e,
                queued=[h.tenant for h in q.handles()],
                pending=[h.tenant for h in q.pending()])


def oracle_leg(mesh, out: str, init: dict) -> dict:
    """The oracle bucket on ``mesh``, each lane from the JAX lane's
    initial state (``init``: tenant -> (state, key))."""
    svc = tservice.GossipService(out, slice_rounds=SLICE + 2,
                                 registry=MetricsRegistry(), mesh=mesh,
                                 device="cpu")
    q = tservice.RunQueue()
    handles = {t: q.submit(request_pair(t, cfg, seed, poison)[1])
               for t, cfg, seed, poison in ORACLE}
    sess = svc.session(q)

    def init_lane(rt, i):
        run = rt.bucket.runs[i]
        state, key = init[run.tenant]
        run.sim.draws = JaxDraws(key, init_key=key)
        return to_port_state(run.sim, state)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tscheduler._BucketRuntime, "_init_lane", init_lane)
        while sess.poll():
            pass
    sess.finish()
    lanes = {}
    for rt in sess.runtimes:
        for i, run in enumerate(rt.bucket.runs):
            whole = parallel.gather_state(rt.states[i], run.sim.mesh)
            lanes[run.tenant] = host_copy(whole)
    return dict(handles={t: dict(status=h.status.value,
                                 rounds=h.rounds_completed, report=h.report)
                         for t, h in handles.items()}, lanes=lanes)


def host_copy(state):
    """``state`` with every tensor on the host (a copy)."""
    from gossipy_tpu_torch.parallel import rules
    return rules.tree_map_with_path(
        lambda _, x: x.detach().cpu().clone()
        if isinstance(x, torch.Tensor) else x, state)


def run_legs(mesh, workdir) -> dict:
    """Both legs on ``mesh``, each in an output directory of its own."""
    tag = "ranks" if mesh.spans_ranks() else "virtual"
    skewed = mesh.spans_ranks() and torch.distributed.get_rank() == 1
    init = torch.load(f"{workdir}/oracle_init.pt", weights_only=False)
    return {"serve": serve_leg(mesh, f"{workdir}/serve-{tag}", skewed),
            "oracle": oracle_leg(mesh, f"{workdir}/oracle-{tag}", init)}


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


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The JAX service on a 2-device mesh admits the oracle bucket (its
    lanes' initial states and keys go to the ranks), the ranks start, and
    the virtual mesh's legs and the rest of the JAX run go on while they
    run. Returns ``(rank outputs, virtual mesh outputs, JAX run,
    workdir)``."""
    workdir = tmp_path_factory.mktemp("service-ranks")
    pairs = [request_pair(t, cfg, seed, poison,
                          jax_params={"fused_merge": "multi"})
             for t, cfg, seed, poison in ORACLE]
    jmesh = jparallel.make_mesh(2)
    jsvc = jservice.GossipService(str(workdir / "jax"), slice_rounds=SLICE + 2,
                                  registry=JRegistry(), mesh=jmesh)
    jq = jservice.RunQueue()
    jhandles = {p[0].tenant: jq.submit(p[0]) for p in pairs}
    jsess = jsvc.session(jq)
    jsess.admit_pending()
    init, sims = {}, {}
    for rt in jsess.runtimes:
        for i, run in enumerate(rt.bucket.runs):
            init[run.tenant] = (jcheckpoint.slice_lane(rt.states, i),
                                np.asarray(run.key))
            sims[run.tenant] = rt.sim
    torch.save(init, workdir / "oracle_init.pt")
    procs = spawn(workdir)
    try:
        virt = run_legs(virtual(), workdir)
        while jsess.poll():
            pass
        jsess.finish()
        final = {run.tenant: jcheckpoint.slice_lane(rt.states, i)
                 for rt in jsess.runtimes
                 for i, run in enumerate(rt.bucket.runs)}
    finally:
        outs = reap(procs, TIMEOUT_S)
    for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{err[-4000:]}"
    got = [torch.load(workdir / f"rank{r}.pt", weights_only=False)
           for r in (0, 1)]
    return got, virt, dict(handles=jhandles, sims=sims, final=final,
                           init=init), workdir


def report_json(rep) -> str:
    return json.dumps(rep, sort_keys=True)


@pytest.mark.parametrize("tenant", sorted(FIRST) + sorted(LATER))
def test_tenants_equal_the_virtual_mesh_service(ranks, tenant):
    """Each tenant's status, rounds and report on both ranks bit-equal to
    the virtual mesh service's."""
    got, virt, _, _ = ranks
    want = virt["serve"]["handles"][tenant]
    assert want["status"] == ("evicted" if tenant == "b" else "done")
    for rank in (0, 1):
        mine = got[rank]["serve"]["handles"][tenant]
        assert mine["status"] == want["status"], rank
        assert mine["rounds"] == want["rounds"], rank
        assert report_json(mine["report"]) == report_json(want["report"])


def test_admission_and_eviction_agree_across_ranks(ranks):
    """The ranks' clocks differ (rank 1's runs ahead, and it waits before
    every cycle), its queue holds ``d`` one cycle early and gets ``e``
    one cycle late, and ``f`` builds on rank 0 alone: both ranks admit
    the same tenants in the same cycles and buckets as the virtual mesh
    service, hold one handle a tenant with none left queued, fail ``f``
    with rank 1's error, and evict ``b`` at the same round with one
    bundle, rank 0's. Rank 1's late submit of ``e`` returns the running
    handle rank 0's request made."""
    got, virt, _, _ = ranks
    want = virt["serve"]
    assert want["admitted"] == {"a": 0, "b": 0, "c": 0, "d": 1, "e": 1}
    assert got[1]["serve"]["late_e"] == {"status": "running",
                                         "supplied": True}
    for rank in (0, 1):
        mine = got[rank]["serve"]
        assert mine["admitted"] == want["admitted"], rank
        assert mine["buckets"] == want["buckets"], rank
        assert sorted(mine["queued"]) == sorted(set(mine["queued"])), rank
        assert mine["pending"] == [], rank
        f = mine["handles"][BROKEN]
        assert f["status"] == "failed" and "no data for f" in f["error"]
    b0, b1 = (got[r]["serve"]["handles"]["b"] for r in (0, 1))
    assert b0["bundle"] is not None and b0["bundle"] == b1["bundle"]
    assert os.path.isfile(os.path.join(b0["bundle"], "verdict.json"))


def test_only_rank_0_writes_the_output_directory(ranks):
    """Rank 0 writes every tenant's report, manifest and events, the
    eviction bundle and the summary; rank 1 writes nothing there, yet
    records the same artifact paths and returns the same summary."""
    got, _, _, workdir = ranks
    assert got[1]["serve"]["writes"] == []
    written = {p for _, p in got[0]["serve"]["writes"]}
    out = str(workdir / "serve-ranks")
    assert os.path.join(out, "service_summary.json") in written
    for t in ("a", "c", "d", "e"):
        arts = got[0]["serve"]["handles"][t]["artifacts"]
        assert arts == got[1]["serve"]["handles"][t]["artifacts"]
        for name in ("report", "manifest", "events"):
            assert os.path.isfile(arts[name]), (t, name)
    assert got[0]["serve"]["summary"] == got[1]["serve"]["summary"]


@pytest.mark.parametrize("tenant", [t for t, *_ in ORACLE])
def test_lanes_match_the_jax_mesh_service(ranks, tenant):
    """Under the JAX draw oracle, each lane of the service across ranks
    against the JAX service's lane on a 2-device mesh: status and rounds
    equal, accounting, boxes and ages exactly, params within 1e-5 and
    accuracy within 2e-5; and bit-equal to the virtual mesh service's
    lane."""
    got, virt, jrun, _ = ranks
    jh = jrun["handles"][tenant]
    assert jh.status is jservice.RunStatus.DONE
    _, cfg, seed, poison = next(r for r in ORACLE if r[0] == tenant)
    tsim = tservice.build_request(request_pair(tenant, cfg, seed, poison)[1],
                                  device="cpu").sim
    for rank in (0, 1):
        mine = got[rank]["oracle"]
        h = mine["handles"][tenant]
        assert h["status"] == jh.status.value, rank
        assert h["rounds"] == jh.rounds_completed, rank
        assert report_json(h["report"].to_dict()) == report_json(
            virt["oracle"]["handles"][tenant]["report"].to_dict())
        assert_same_run(jrun["sims"][tenant], tsim, jrun["final"][tenant],
                        mine["lanes"][tenant], jh.report, h["report"],
                        metric_tol=2e-5)


@pytest.mark.parametrize("status", ["queued", "running", "done"])
def test_a_supplied_request_is_the_callers_own(status):
    """A request rank 0 supplied to a lagging rank's queue
    (``RunQueue.supply``) is the one that rank's caller submits later,
    whatever its status by then: the submit returns that handle, queues
    nothing more and refuses nothing; a second submit of the tenant is
    the caller's own again, refused while the first is queued or
    running."""
    q = tservice.RunQueue()
    supplied = q.supply(request("e", LATER["e"]))
    supplied.status = tservice.RunStatus(status)
    assert q.submit(request("e", LATER["e"])) is supplied
    assert q.handles() == [supplied]
    assert q.pending() == ([supplied] if status == "queued" else [])
    if status == "done":
        again = q.submit(request("e", LATER["e"]))
        assert again is not supplied and q.pending() == [again]
    else:
        with pytest.raises(ValueError, match="already has"):
            q.submit(request("e", LATER["e"]))
