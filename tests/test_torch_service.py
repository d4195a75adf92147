"""The multi-tenant service (``gossipy_tpu_torch/service``) against the JAX
package's (``gossipy_tpu/service``), on the CPU.

At the sizes of ``tests/test_service.py`` (16 nodes, degree 4, 6 rounds,
8 synthetic features, its ``tenant_data`` rule):

1. **Packing.** The JAX packer's request sets give the same partition
   into buckets, in the same order, in both packages; the signature
   fields that are counts or digests are equal (the data's dtypes as JAX
   canonicalizes the port's: JAX keeps int64 labels as int32); the spec
   validation raises alike; ``schedule_shape_summary`` equals the JAX
   function's on a dense and a sparse chaos schedule.
2. **The served lane equals the JAX served lane** under the JAX draw
   oracle: each port lane starts from the JAX lane's initial state
   (``_BucketRuntime._init_lane`` stood in for) and draws through
   ``JaxDraws`` from the lane's ``set_seed`` key. ``good`` plus a
   poisoned ``bad`` at ``slice_rounds=4`` on an fp32 ring (the port's
   default deliver, K1's plain version, against the JAX multi deliver's
   kernel in interpret mode; and both on ``fused_merge=False``), and two
   tenants on a bf16 ring (K2's plain version): accounting, both boxes,
   ages and the eviction round exactly, params within 1e-5 (bf16: plus
   half a bf16 step), accuracy curves within 2e-5.
3. **The served lane equals its solo port run**, every report array bit
   for bit: ``run_experiment`` with the sentinels on, and, under
   ``eval_every=2`` with a sampled eval, the same rounds run as
   ``start`` calls of ``slice_rounds`` each.
4. **Eviction and artifacts** (``TestSchedulerE2E`` on the port).
5. **The SLO harness**: ``run_load``'s row has the JAX row's keys and no
   missing TTFR; a tenant arriving mid-flight in a ``ServiceSession``.

Every service run of both packages has a private metrics registry, so
this file leaves nothing in either process registry.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from gossipy_tpu import checkpoint as jcheckpoint
from gossipy_tpu import core as jcore
from gossipy_tpu import service as jservice
from gossipy_tpu.config import ExperimentConfig as JConfig
from gossipy_tpu.simulation import faults as jfaults
from gossipy_tpu.telemetry.metrics import MetricsRegistry as JRegistry
from gossipy_tpu_torch import core as tcore
from gossipy_tpu_torch import service as tservice
from gossipy_tpu_torch.config import ExperimentConfig as TConfig
from gossipy_tpu_torch.config import build_experiment, run_experiment
from gossipy_tpu_torch.service import scheduler as tscheduler
from gossipy_tpu_torch.simulation import faults as tfaults
from gossipy_tpu_torch.telemetry.metrics import MetricsRegistry
from torch_oracle import JaxDraws
from torch_pairs import assert_same_run, to_port_state

D_FEATURES = 8
SLICE = 4


def tenant_data(seed: int, n: int = 240, d: int = D_FEATURES,
                poison: bool = False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X @ rng.normal(size=d) > 0).astype(np.int64)
    if poison:
        X[: n // 8] = np.inf
    return X, y


def base(**over) -> dict:
    b = dict(n_nodes=16, model="logreg", handler="sgd",
             topology="random_regular", topology_params={"degree": 4},
             delta=20, n_rounds=6, batch_size=8)
    b.update(over)
    return b


def request_pair(tenant, cfg: dict, data_seed=1, poison=False, n=240,
                 jax_params=None):
    """The same request in both packages (the same data arrays);
    ``jax_params`` adds simulator params on the JAX side only."""
    data = tenant_data(data_seed, n=n, poison=poison)
    jcfg = cfg if not jax_params else {**cfg, "simulator_params": {
        **cfg.get("simulator_params", {}), **jax_params}}
    return (jservice.RunRequest(tenant, JConfig(**jcfg), data=data),
            tservice.RunRequest(tenant, TConfig(**cfg), data=data))


# -- 1. packing ----------------------------------------------------------------

# The request sets of the JAX TestPacker (tests/test_service.py:63-128):
# (tenant, config fields, data seed, samples).
PACKER_SETS = {
    "variable_fields_fuse": [
        ("a", base(seed=1), 1, 240),
        ("b", base(seed=2, drop_prob=0.2), 2, 240),
        ("c", base(seed=3, online_prob=0.8, n_rounds=9), 3, 240)],
    "shape_fields_split": [
        ("a", base(seed=1), 1, 240),
        ("n", base(seed=1, n_nodes=24), 2, 240),
        ("m", base(seed=1, model="mlp"), 3, 240),
        ("w", base(seed=1, simulator_params={"history_dtype": "bfloat16"}),
         4, 240)],
    "topology_content_splits": [
        ("a", base(seed=1), 1, 240),
        ("d", base(seed=1, topology_params={"degree": 6}), 2, 240)],
    "data_shape_splits": [
        ("a", base(seed=1), 1, 240),
        ("big", base(seed=1), 2, 480)],
    "sentinel_injection_in_signature": [
        ("a", base(seed=1), 1, 240),
        ("off", base(seed=1, simulator_params={"sentinels": False}), 2,
         240)],
}

# The signature fields that are counts or digests.
SIGNATURE_FIELDS = ("n_nodes", "mailbox_slots", "reply_slots",
                    "max_fires_per_round", "topology", "config", "probes",
                    "sentinels", "cohort", "chaos_shape")


@pytest.fixture(scope="module")
def packed():
    out = {}
    for name, reqs in PACKER_SETS.items():
        jb, tb = [], []
        for tenant, cfg, seed, n in reqs:
            jr, tr = request_pair(tenant, cfg, seed, n=n)
            jb.append(jservice.build_request(jr))
            tb.append(tservice.build_request(tr, device="cpu"))
        out[name] = (jb, tb)
    return out


@pytest.mark.parametrize("name", sorted(PACKER_SETS))
def test_packing_partition_equals_jax(packed, name):
    jb, tb = packed[name]
    jparts = [b.tenants for b in jservice.pack(jb)]
    tparts = [b.tenants for b in tservice.pack(tb)]
    assert tparts == jparts
    # The JAX test's own expectations hold on the port.
    want = {"variable_fields_fuse": 1, "shape_fields_split": 4,
            "topology_content_splits": 2, "data_shape_splits": 2,
            "sentinel_injection_in_signature": 2}[name]
    assert len(tparts) == want
    if name == "sentinel_injection_in_signature":
        assert tb[0].sim.sentinels is not None and tb[1].sim.sentinels is None


@pytest.mark.parametrize("name", sorted(PACKER_SETS))
def test_signature_fields_equal_jax(packed, name):
    for j, t in zip(*packed[name]):
        js, ts = j.signature.summary, t.signature.summary
        assert sorted(ts) == sorted(js)
        for field in SIGNATURE_FIELDS:
            assert ts[field] == js[field], field
        assert sorted(ts["data_shapes"]) == sorted(js["data_shapes"])
        for k, (shape, dtype) in ts["data_shapes"].items():
            jshape, jdtype = js["data_shapes"][k]
            assert shape == jshape, k
            assert str(jax.dtypes.canonicalize_dtype(np.dtype(dtype))) \
                == jdtype, k
        assert t.handle.bucket == t.signature.digest


SPEC_CASES = {
    "sequential": lambda C: dict(config=C(**base(simulator="sequential"))),
    "pens": lambda C: dict(config=C(**base(simulator="pens"))),
    "repetitions": lambda C: dict(config=C(**base(repetitions=2))),
    "cohort": lambda C: dict(config=C(**base(cohort={"size": 8}))),
    "slash": lambda C: dict(tenant="a/b", config=C(**base())),
    "empty": lambda C: dict(tenant="", config=C(**base())),
}


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type and text are held
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_spec_validation_raises_alike(case):
    def make(pkg, C):
        kw = {"tenant": "t", **SPEC_CASES[case](C)}
        return lambda: pkg.RunRequest(**kw)
    got = _raised(make(tservice, TConfig))
    assert got is not None and got == _raised(make(jservice, JConfig))


def test_spec_parsing_and_queue_refuse_alike():
    bad_spec = {"tenant": "t", "config": {}, "extra": 1}
    assert _raised(lambda: tservice.RunRequest.from_spec(bad_spec)) == \
        _raised(lambda: jservice.RunRequest.from_spec(bad_spec))
    assert _raised(lambda: tservice.RunRequest.from_spec({"tenant": "t"})) \
        == _raised(lambda: jservice.RunRequest.from_spec({"tenant": "t"}))
    spec = {"tenant": "s", "config": base(seed=3), "n_rounds": 9}
    t, j = tservice.RunRequest.from_spec(spec), \
        jservice.RunRequest.from_spec(spec)
    assert (t.tenant, t.rounds) == (j.tenant, j.rounds) == ("s", 9)
    for pkg, C in ((tservice, TConfig), (jservice, JConfig)):
        q = pkg.RunQueue()
        q.submit(pkg.RunRequest("t", C(**base())))
        with pytest.raises(ValueError, match="already has"):
            q.submit(pkg.RunRequest("t", C(**base(seed=2))))


@pytest.mark.parametrize("sparse", [False, True])
def test_schedule_shape_summary_equals_jax(sparse):
    n = 16
    edges = [(i, (i + d) % n) for i in range(n) for d in (1, 2)]
    chaos = dict(horizon=10,
                 partitions=[dict(start=2, stop=6,
                                  components=[list(range(8))])],
                 outages=[dict(start=1, stop=3, nodes=[0, 1])],
                 spikes=[dict(start=4, stop=5, drop_prob=0.3)])
    out = []
    for core, faults in ((jcore, jfaults), (tcore, tfaults)):
        if sparse:
            topo = core.SparseTopology(n, np.array(edges))
        else:
            adj = np.zeros((n, n), bool)
            for i, j in edges:
                adj[i, j] = adj[j, i] = True
            topo = core.Topology(adj)
        sched = faults.build_fault_schedule(
            faults.ChaosConfig.from_dict(chaos), topo, 0.05)
        out.append(faults.schedule_shape_summary(sched))
    assert out[1] == out[0]
    assert (out[1]["edge_masks"] is None) == sparse
    assert (out[1]["slot_masks"] is None) != sparse


# -- 2. the served lane against the JAX served lane, under the oracle ----------

def jax_serve(reqs, out, slice_rounds=SLICE) -> dict:
    """The JAX service over ``reqs``: the lanes' initial states and keys
    (read after admission), the handles, the buckets' representative
    simulators and the lanes' final states."""
    svc = jservice.GossipService(str(out), slice_rounds=slice_rounds,
                                 registry=JRegistry())
    q = jservice.RunQueue()
    handles = {r.tenant: q.submit(r) for r in reqs}
    sess = svc.session(q)
    sess.admit_pending()
    init, keys, sims = {}, {}, {}
    for rt in sess.runtimes:
        for i, run in enumerate(rt.bucket.runs):
            init[run.tenant] = jcheckpoint.slice_lane(rt.states, i)
            keys[run.tenant] = run.key
            sims[run.tenant] = rt.sim
    while sess.poll():
        pass
    summary = sess.finish()
    final = {run.tenant: jcheckpoint.slice_lane(rt.states, i)
             for rt in sess.runtimes
             for i, run in enumerate(rt.bucket.runs)}
    return dict(handles=handles, init=init, keys=keys, sims=sims,
                final=final, summary=summary)


def port_serve(reqs, out, slice_rounds=SLICE, jax_run=None) -> dict:
    """The port's service over ``reqs`` on the CPU; with ``jax_run``,
    each lane starts from the JAX lane's initial state and draws through
    the oracle from the lane's key."""
    svc = tservice.GossipService(str(out), slice_rounds=slice_rounds,
                                 registry=MetricsRegistry(), device="cpu")
    q = tservice.RunQueue()
    handles = {r.tenant: q.submit(r) for r in reqs}
    sess = svc.session(q)
    with pytest.MonkeyPatch.context() as mp:
        if jax_run is not None:
            def init_lane(rt, i):
                run = rt.bucket.runs[i]
                key = jax_run["keys"][run.tenant]
                run.sim.draws = JaxDraws(key, init_key=key)
                return to_port_state(run.sim, jax_run["init"][run.tenant])
            mp.setattr(tscheduler._BucketRuntime, "_init_lane", init_lane)
        while sess.poll():
            pass
    summary = sess.finish()
    lanes = {run.tenant: (run.sim, rt.states[i])
             for rt in sess.runtimes
             for i, run in enumerate(rt.bucket.runs)}
    return dict(handles=handles, lanes=lanes, summary=summary, session=sess)


# (tenant, config fields, data seed, poisoned) of each oracle bucket. The
# port's configs name no deliver: its default is "multi" (K1's and K2's
# plain versions on the CPU), which the JAX side names (its default is
# the plain deliver, whose per-slot updates count other ages).
JAX_PARAMS = {"fp32": {"fused_merge": "multi"}, "fp32-plain": None,
              "bf16": {"fused_merge": "multi"}}
ORACLE_BUCKETS = {
    "fp32": [("good", base(seed=1), 1, False),
             ("bad", base(seed=2), 2, True)],
    "fp32-plain": [
        ("good", base(seed=1, simulator_params={"fused_merge": False}), 1,
         False),
        ("bad", base(seed=2, simulator_params={"fused_merge": False}), 2,
         True)],
    "bf16": [
        ("p", base(seed=3, simulator_params={"history_dtype": "bfloat16"}),
         3, False),
        ("q", base(seed=4, drop_prob=0.1,
                   simulator_params={"history_dtype": "bfloat16"}), 4,
         False)],
}


@pytest.fixture(scope="module", params=sorted(ORACLE_BUCKETS))
def oracle_pair(request, tmp_path_factory):
    name = request.param
    pairs = [request_pair(t, cfg, seed, poison, jax_params=JAX_PARAMS[name])
             for t, cfg, seed, poison in ORACLE_BUCKETS[name]]
    out = tmp_path_factory.mktemp(f"oracle-{name}")
    jrun = jax_serve([p[0] for p in pairs], out / "jax")
    trun = port_serve([p[1] for p in pairs], out / "port", jax_run=jrun)
    return name, jrun, trun


def test_served_lane_equals_jax_served_lane(oracle_pair):
    name, jrun, trun = oracle_pair
    assert trun["summary"]["n_buckets"] == jrun["summary"]["n_buckets"] == 1
    for tenant, jh in jrun["handles"].items():
        th = trun["handles"][tenant]
        assert th.status.value == jh.status.value, tenant
        assert th.rounds_completed == jh.rounds_completed, tenant
        tsim, tst = trun["lanes"][tenant]
        assert tsim.fused_merge == jrun["sims"][tenant].fused_merge == (
            False if name == "fp32-plain" else "multi")
        jrep, trep = jh.report, th.report
        for field in ("sent_per_round", "failed_per_round",
                      "mailbox_hwm_per_round", "health_trip"):
            np.testing.assert_array_equal(getattr(trep, field),
                                          getattr(jrep, field),
                                          err_msg=f"{tenant} {field}")
        for cause, v in jrep.failed_per_cause.items():
            np.testing.assert_array_equal(trep.failed_per_cause[cause], v)
        if jh.status is jservice.RunStatus.EVICTED:
            verdicts = []
            for h in (jh, th):
                with open(os.path.join(h.bundle_path, "verdict.json")) as fh:
                    verdicts.append(json.load(fh))
            assert verdicts[0]["first_bad_round"] == \
                verdicts[1]["first_bad_round"] == 0
            continue
        # Both lanes ran the same whole slices (rows past the request
        # dropped): their final states are comparable.
        assert_same_run(jrun["sims"][tenant], tsim, jrun["final"][tenant],
                        tst, jrep, trep, metric_tol=2e-5)
    statuses = sorted(h.status.value for h in trun["handles"].values())
    assert statuses == (["done", "evicted"] if name.startswith("fp32")
                        else ["done", "done"])


# -- 3. the served lane against its solo port run --------------------------------

CFG_GOOD, CFG_BAD = base(seed=1), base(seed=2)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One port service run shared by groups 3 and 4: ``good`` and the
    poisoned ``bad`` in one bucket, at ``slice_rounds=4``."""
    out = tmp_path_factory.mktemp("served")
    reqs = [tservice.RunRequest("good", TConfig(**CFG_GOOD),
                                data=tenant_data(1)),
            tservice.RunRequest("bad", TConfig(**CFG_BAD),
                                data=tenant_data(2, poison=True))]
    return port_serve(reqs, out)


def with_sentinels(cfg: dict) -> TConfig:
    return TConfig(**{**cfg, "simulator_params": {
        **cfg.get("simulator_params", {}), "sentinels": True}})


def same_report(a, b) -> bool:
    return json.dumps(a.to_dict(), sort_keys=True) == \
        json.dumps(b.to_dict(), sort_keys=True)


def test_served_lane_equals_solo_run(served):
    _, solo = run_experiment(with_sentinels(CFG_GOOD), data=tenant_data(1),
                             device="cpu")
    assert same_report(served["handles"]["good"].report, solo)


def test_served_lane_equals_chunked_solo_run_under_eval_every(
        tmp_path_factory):
    """Under ``eval_every=2`` a slice's last round evaluates (a
    segment-final round) and the sampled eval draws from the stream: the
    served lane equals the same rounds run as ``start`` calls of
    ``slice_rounds`` each."""
    from gossipy_tpu_torch import set_seed
    cfg = base(seed=5, eval_every=2, sampling_eval=0.5)
    data = tenant_data(5)
    run = port_serve([tservice.RunRequest("e", TConfig(**cfg), data=data)],
                     tmp_path_factory.mktemp("every"), slice_rounds=3)
    served_rep = run["handles"]["e"].report
    gen = set_seed(cfg["seed"])
    sim, _ = build_experiment(with_sentinels(cfg), data, device="cpu")
    st = sim.init_nodes(gen)
    rows = []
    for _ in range(2):
        st, rep = sim.start(st, n_rounds=3)
        rows.append(rep.to_dict())
    got = served_rep.to_dict()
    for k in ("sent_per_round", "failed_per_round", "global_evals",
              "health_trip", "mailbox_hwm_per_round"):
        assert got[k] == rows[0][k] + rows[1][k], k
    # Round 2 ends the first slice: evaluated, where eval_every alone
    # would skip it.
    assert got["global_evals"][2][0] is not None


# -- 4. eviction and artifacts (TestSchedulerE2E on the port) --------------------

def test_one_bucket_and_the_summary_keys(served):
    s = served["summary"]
    assert s["n_buckets"] == 1 and s["megabatch_step_programs"] == 1
    b = s["buckets"][0]
    assert sorted(b["tenants"]) == ["bad", "good"]
    # The port compiles nothing: no cache and no jit caches.
    assert b["compilation_cache"] is None
    assert b["step_jit_cache_size"] is None
    assert b["init_jit_cache_size"] is None


def test_co_tenant_completes_clean(served):
    h = served["handles"]["good"]
    assert h.status is tservice.RunStatus.DONE
    assert h.rounds_completed == 6
    assert int(np.sum(h.report.health_trip)) == 0


def test_poisoned_tenant_evicted_with_bundle(served):
    h = served["handles"]["bad"]
    assert h.status is tservice.RunStatus.EVICTED
    assert h.bundle_path is not None and os.path.isdir(h.bundle_path)
    with open(os.path.join(h.bundle_path, "verdict.json")) as fh:
        verdict = json.load(fh)
    assert verdict["kind"] == "sentinel"
    assert verdict["first_bad_round"] == 0
    assert verdict["detail"]["tenant"] == "bad"
    assert verdict["detail"]["nonfinite_params_total"] > 0
    assert h.rounds_completed == 1
    assert int(np.asarray(h.report.health_trip)[-1]) > 0


def test_bundle_replays_to_the_recorded_round(served):
    from gossipy_tpu_torch.telemetry.health import replay_bundle
    sim, _ = build_experiment(with_sentinels(CFG_BAD),
                              tenant_data(2, poison=True), device="cpu")
    verdict = replay_bundle(served["handles"]["bad"].bundle_path, sim,
                            localize=False)
    assert verdict["first_bad_round"] == 0
    assert verdict["matches_recorded"] is True
    assert verdict["trip"] == "nonfinite"


def test_per_tenant_artifacts(served):
    from gossipy_tpu_torch.simulation.events import JSONLinesReceiver
    for name in ("good", "bad"):
        h = served["handles"][name]
        assert os.path.isfile(h.artifacts["report"])
        assert os.path.isfile(h.artifacts["manifest"])
        with open(h.artifacts["events"]) as fh:
            rows = [JSONLinesReceiver.parse_line(line) for line in fh]
        assert len(rows) == h.rounds_completed
        assert rows[0]["round"] == 1
        assert all(r["health"] is not None for r in rows)
    assert rows[-1]["health"]["trip"] is True


def test_per_tenant_manifest_attribution(served):
    with open(served["handles"]["bad"].artifacts["manifest"]) as fh:
        m = json.load(fh)
    assert m["config"]["tenant"] == "bad"
    assert m["config"]["seed"] == 2
    svc = m["extra"]["service"]
    assert svc["bucket"] == served["summary"]["buckets"][0]["bucket"]
    assert sorted(svc["bucket_tenants"]) == ["bad", "good"]
    assert svc["status"] == "evicted"
    assert "bucket_compilation_cache" in svc
    assert "data_shapes" in svc["signature"]
    # FLOPs from the analytic count of one round, for the one round the
    # evicted tenant took.
    flops = svc["perf"]["step_program"]["flops_per_round"]
    assert svc["perf"]["tenant_flops_est"] == pytest.approx(flops)


def test_tenant_tagged_sink_routing(served):
    from gossipy_tpu_torch.telemetry import get_sink
    sink = get_sink()
    mine = sink.events(kind="round",
                       where=lambda e: e.data.get("tenant") == "good")
    if mine:  # the ring may have been rotated by other tests
        assert all(e.data["tenant"] == "good" for e in mine)
    evs = sink.events(kind="tenant_evicted")
    assert any(e.data["tenant"] == "bad" for e in evs)


def test_unported_mesh_raises(tmp_path):
    """A mesh across processes (the state placed across cards, queue 1
    item 13) is refused; a virtual mesh is the ported one."""
    from gossipy_tpu_torch import parallel
    across = parallel.make_mesh(devices=[
        parallel.Position(torch.device("cpu"), rank, rank)
        for rank in (0, 1)])
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        tservice.GossipService(str(tmp_path), mesh=across, device="cpu")


# -- 5. the SLO harness ------------------------------------------------------------

def test_slo_row_has_the_jax_keys(tmp_path):
    reg = MetricsRegistry()
    res = tservice.run_load(str(tmp_path), n_tenants=6, time_scale=0.01,
                            registry=reg, device="cpu")
    row = res["row"]
    want = jservice.slo_row(jservice.RunQueue(), JRegistry(), 1.0)
    assert sorted(row) == sorted(want)
    assert sorted(row["raw"]) == sorted(want["raw"])
    raw = row["raw"]
    assert raw["ttfr_missing"] == []
    assert raw["n_admitted"] == raw["ttfr_recorded"] == 6
    assert raw["n_failed"] == 0 and raw["n_done"] == 6
    assert res["summary"]["n_buckets"] >= 2
    assert row["value"] > 0 and raw["round_p99_ms"] is not None


def test_session_admits_a_tenant_mid_flight(tmp_path):
    svc = tservice.GossipService(str(tmp_path), slice_rounds=2,
                                 registry=MetricsRegistry(), device="cpu")
    q = tservice.RunQueue()
    first = q.submit(tservice.RunRequest("first", TConfig(**base(seed=1)),
                                         data=tenant_data(1)))
    sess = svc.session(q)
    assert sess.poll()                       # admits and runs one slice
    assert first.status is tservice.RunStatus.RUNNING
    assert first.rounds_completed == 2
    late = q.submit(tservice.RunRequest("late", TConfig(**base(seed=2)),
                                        data=tenant_data(2)))
    while sess.poll():
        pass
    summary = sess.finish()
    assert first.status is late.status is tservice.RunStatus.DONE
    # The same shape, admitted later: a bucket of its own.
    assert summary["n_buckets"] == 2
    assert late.first_round_at > first.first_round_at
    assert late.submitted_at > first.submitted_at
    assert late.rounds_completed == first.rounds_completed == 6
