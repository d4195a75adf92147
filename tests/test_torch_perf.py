"""The performance layer (``telemetry/cost.py``, ``telemetry/scopes.py``,
the engine's ``perf=`` and ``start(profile_dir=...)``) and the engine's
sink events, held against the JAX package's.

- ``analytic_round_cost`` of the same configuration in both packages:
  LogReg(57, 2) (the north star's model), an MLP and CIFAR10Net (the
  flagship's). Every key agrees exactly: the port counts one node's
  update and evaluation with ``FlopCounterMode`` on ``meta`` tensors, the
  JAX package walks their jaxprs; both count the matmul and convolution
  terms (CIFAR10Net's im2col ``bmm`` against the JAX einsum), the
  backward's weight products but no input gradient of the first layer,
  and every batch of the padded shard.
- ``PerfConfig``, ``CostReport``, ``mfu_estimate``'s and
  ``peak_flops``' null safety, the H100 peak table.
- ``perf=`` on the engine: ``perf_summary``'s keys, the ``perf_*`` report
  rows and the JSONL ``perf`` field; all null with ``perf=`` off.
- A run with ``perf``, ``metrics``, ``ledger`` and ``tracing`` all on is
  bit-identical to the run with all off, on every deliver path.
- The phase ranges: the same names as the JAX scopes; a CPU
  ``start(profile_dir=...)`` trace holds the four round phases and
  ``phase_times_from_trace`` gives each a positive time within the run's
  wall; hand-made Chrome traces (nested ranges, doubled CPU/GPU copies,
  nested ops, the correlation route) reduce without double counting.
- ``differential_phase_attribution``: the three legs sum to the whole.
- The sink events ``mailbox_undersized``, ``probes_summary`` and
  ``sentinel_trip`` carry the JAX engine's payload keys and values.
"""

import dataclasses
import gzip
import json
import os
import time
import warnings

import jax
import numpy as np
import optax
import pytest
import torch

from gossipy_tpu import core as jcore
from gossipy_tpu import simulation as jsimulation
from gossipy_tpu.data import ClassificationDataHandler, DataDispatcher
from gossipy_tpu.handlers import SGDHandler, losses
from gossipy_tpu.models import CIFAR10Net, MLP, LogisticRegression
from gossipy_tpu.simulation.events import \
    JSONLinesReceiver as JJSONLinesReceiver
from gossipy_tpu.telemetry import cost as jcost
from gossipy_tpu.telemetry import scopes as jscopes
from gossipy_tpu.telemetry import sink as jsink
from gossipy_tpu_torch import core as tcore
from gossipy_tpu_torch import simulation as tsimulation
from gossipy_tpu_torch.handlers import SGDHandler as TSGDHandler
from gossipy_tpu_torch.handlers import losses as tlosses
from gossipy_tpu_torch.models import CIFAR10Net as TCIFAR10Net
from gossipy_tpu_torch.models import MLP as TMLP
from gossipy_tpu_torch.models import LogisticRegression as TLogReg
from gossipy_tpu_torch.random import TorchDraws
from gossipy_tpu_torch.simulation.events import CallbackReceiver, \
    JSONLinesReceiver
from gossipy_tpu_torch.telemetry import cost, scopes, sink
from gossipy_tpu_torch.telemetry import ProbeConfig, RunLedger, Tracer
from torch_oracle import JaxDraws
from torch_pairs import PATHS, clique_pair, small_data, to_port_state

torch.set_num_threads(1)

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module")
def key():
    return jax.random.PRNGKey(0)


# -- the analytic cost model, port against reference ------------------------

def _tabular(n_nodes, d, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(40 * n_nodes, d)).astype(np.float32)
    y = (X @ rng.normal(size=d) > 0).astype(np.int64)
    return DataDispatcher(ClassificationDataHandler(X, y, test_size=0.2,
                                                    seed=42),
                          n=n_nodes, eval_on_user=False).stacked()


def _images(n_nodes):
    rng = np.random.default_rng(3)
    X = rng.normal(size=(20 * n_nodes, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 20 * n_nodes)
    Xte = rng.normal(size=(12, 32, 32, 3)).astype(np.float32)
    yte = rng.integers(0, 10, 12)
    return DataDispatcher(ClassificationDataHandler(X, y, Xte, yte),
                          n=n_nodes, eval_on_user=False).stacked()


# (JAX model, port model, input shape, classes, nodes, batch, data, the
# simulator's options): the north star's model on a 20-regular graph of 24
# nodes with a short shard (a padded, partly masked batch), a two-layer MLP
# with two local epochs and a sampled eval, CIFAR10Net on 4 nodes with a
# local test set too.
COST_CASES = {
    "logreg": (lambda: LogisticRegression(57, 2), lambda: TLogReg(57, 2),
               (57,), 2, 24, 32, lambda: _tabular(24, 57, 1),
               dict(local_epochs=1), dict()),
    "mlp": (lambda: MLP(20, 3, (32, 16)), lambda: TMLP(20, 3, (32, 16)),
            (20,), 3, 16, 8, lambda: _tabular(16, 20, 2),
            dict(local_epochs=2), dict(sampling_eval=0.25, eval_every=3)),
    "cnn": (lambda: CIFAR10Net(), lambda: TCIFAR10Net(), (32, 32, 3), 10, 4,
            8, lambda: _images(4), dict(local_epochs=1), dict()),
}


def cost_pair(name):
    jm, tm, shape, n_cls, n, batch, data, hkw, skw = COST_CASES[name]
    stacked = data()
    if name == "cnn":
        # A local test set beside the global one: both eval passes count.
        stacked["xte"] = stacked["xtr"][:, :6]
        stacked["yte"] = stacked["ytr"][:, :6]
        stacked["mte"] = stacked["mtr"][:, :6]
    jh = SGDHandler(model=jm(), loss=losses.cross_entropy,
                    optimizer=optax.sgd(0.1), batch_size=batch,
                    n_classes=n_cls, input_shape=shape, **hkw)
    th = TSGDHandler(tm(), tlosses.cross_entropy, learning_rate=0.1,
                     batch_size=batch, n_classes=n_cls, input_shape=shape,
                     **hkw)
    topo = tcore.Topology.random_regular(n, min(20, n - 1), seed=42)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsim = jsimulation.GossipSimulator(
            jh, jcore.Topology(topo.adjacency), stacked, delta=100, **skw)
        tsim = tsimulation.GossipSimulator(th, topo, stacked, delta=100,
                                           device="cpu", **skw)
    return jsim, tsim


@pytest.mark.parametrize("name", sorted(COST_CASES))
def test_analytic_round_cost_matches_jax(name):
    """Every key of the estimate equals the JAX package's: the counts
    exactly, the composed FLOP and byte figures within 1e-9 relative."""
    jsim, tsim = cost_pair(name)
    want = jcost.analytic_round_cost(jsim)
    got = cost.analytic_round_cost(tsim)
    assert want is not None and got is not None
    assert sorted(got) == sorted(want)
    for k in ("param_count", "train_flops_per_node",
              "merge_flops_per_message", "eval_flops_per_round",
              "expected_deliver_passes"):
        assert got[k] == want[k], k
    for k in ("flops_per_round", "flops_per_round_executed",
              "bytes_per_round"):
        assert got[k] == pytest.approx(want[k], rel=1e-9, abs=0), k
    assert got["train_flops_per_node"] > 0 and got["eval_flops_per_round"] > 0


def test_analytic_count_touches_nothing():
    """The count runs on ``meta`` tensors: no draw from the run's
    provider, the state's tensors untouched, the same answer twice."""
    _, tsim = cost_pair("logreg")
    st = tsim.init_nodes()
    drawn = json.dumps(tsim.draws.get_state(), default=str)
    params = st.model.params.clone()
    a = cost.analytic_round_cost(tsim)
    assert json.dumps(tsim.draws.get_state(), default=str) == drawn
    assert torch.equal(st.model.params, params)
    assert cost.analytic_round_cost(tsim) == a
    # A handler that resists shape-only counting gives None, not an error.
    tsim.handler = object()
    assert cost.analytic_round_cost(tsim) is None


def test_count_flops_backward_terms():
    """``count_flops``: a forward ``x @ W`` over a batch and its backward
    with respect to W only (no input gradient), as jax.grad over the
    params counts it."""
    x = torch.zeros(1, 32, 57, device="meta")
    w = torch.zeros(1, 57, 2, device="meta", requires_grad=True)

    def step():
        with torch.enable_grad():
            loss = torch.bmm(x, w).sum()
            torch.autograd.grad(loss, w)
    assert cost.count_flops(step) == 2 * (2 * 32 * 57 * 2)


# -- the peak table, PerfConfig, CostReport ----------------------------------

def test_perf_config_coerce():
    assert cost.PerfConfig.coerce(None) is None
    assert cost.PerfConfig.coerce(False) is None
    assert cost.PerfConfig.coerce(True) == cost.PerfConfig()
    off = cost.PerfConfig(cost=False, analytic=False, timing=False)
    assert cost.PerfConfig.coerce(off) is None
    some = cost.PerfConfig(cost=False)
    assert cost.PerfConfig.coerce(some) is some
    with pytest.raises(TypeError):
        cost.PerfConfig.coerce("yes")
    for cfg in (cost.PerfConfig(), some):
        assert cfg.to_dict() == jcost.PerfConfig(**cfg.to_dict()).to_dict()
    assert [f.name for f in dataclasses.fields(cost.PerfConfig)] == \
        [f.name for f in dataclasses.fields(jcost.PerfConfig)]


def test_peak_flops_and_mfu_null_safety():
    assert cost.PEAK_FLOPS == {"NVIDIA H100 80GB HBM3": 989e12,
                               "NVIDIA H100 PCIe": 756e12,
                               "NVIDIA H100 NVL": 835e12}
    assert not torch.cuda.is_available()
    assert cost.current_device_kind() is None
    assert cost.peak_flops() is None
    assert cost.peak_flops("cpu") is None
    assert cost.peak_flops("NVIDIA A100-SXM4-80GB") is None
    assert cost.peak_flops(H100) == 989e12
    assert cost.mfu_estimate(None, 1.0, H100) is None
    assert cost.mfu_estimate(1e9, None, H100) is None
    assert cost.mfu_estimate(1e9, 0.0, H100) is None
    assert cost.mfu_estimate(1e9, 1.0, "cpu") is None
    assert cost.mfu_estimate(1e9, 1.0) is None
    assert cost.mfu_estimate(989e9, 0.5, H100) == pytest.approx(2e-3)


def test_cost_report_matches_jax_dataclass():
    assert [f.name for f in dataclasses.fields(cost.CostReport)] == \
        [f.name for f in dataclasses.fields(jcost.CostReport)]
    cr = cost.CostReport(label="x", n_rounds=2,
                         extra={"max_memory_allocated": 7})
    jr = jcost.CostReport(label="x", n_rounds=2,
                          extra={"max_memory_allocated": 7})
    assert cr.to_dict() == jr.to_dict() and cr.peak_bytes is None
    _, tsim = cost_pair("logreg")
    assert cost.cost_report_for(tsim) is None
    assert cost.PERF_STAT_KEYS == jcost.PERF_STAT_KEYS
    for vals in ({}, {"perf_round_ms": 3.5}, {"perf_mfu_est": float("nan")},
                 {"perf_round_ms": 1.0, "perf_mfu_est": 0.25}):
        assert cost.perf_event_row(vals) == jcost.perf_event_row(vals)


# -- perf= on the engine ------------------------------------------------------

def test_perf_summary_rows_and_jsonl_match_jax(key, tmp_path):
    """``perf=True`` in both engines: the summary's keys (the JAX one also
    has the XLA cross-check ratio, which the port cannot have), the last
    run's keys, the ``perf_*`` rows in the report and the JSONL ``perf``
    field; the port's XLA fields null, ``compile_count`` 0, the analytic
    block the JAX one."""
    jsim, tsim = clique_pair(key, fused_merge="multi", perf=True)
    jst = jsim.init_nodes(key)
    tst = to_port_state(tsim, jst)
    jpath, tpath = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    with JJSONLinesReceiver(jpath) as jrx, JSONLinesReceiver(tpath) as trx:
        jsim.add_receiver(jrx)
        tsim.add_receiver(trx)
        jst, jrep = jsim.start(jst, n_rounds=3, key=key)
        tst, trep = tsim.start(tst, n_rounds=3)
    js, ts = jsim.perf_summary(), tsim.perf_summary()
    assert sorted(ts) == sorted(set(js) - {"analytic_vs_xla_flops_ratio"})
    assert sorted(ts["last_run"]) == sorted(js["last_run"])
    assert ts["config"] == js["config"]
    assert ts["device_kind"] == "cpu" and ts["peak_flops"] is None
    assert ts["compile_count"] == 0
    assert ts["flops_per_round_xla"] is None
    assert ts["bytes_per_round_xla"] is None
    assert ts["hbm_peak_bytes"] is None
    assert ts["analytic"]["flops_per_round"] == \
        js["analytic"]["flops_per_round"]
    last = ts["last_run"]
    assert last["rounds"] == 3 and last["ms_per_round"] > 0
    assert last["mfu_est"] is None and last["cold"] is False
    assert last["flops_per_round"] == ts["analytic"]["flops_per_round"]
    assert [p["label"] for p in ts["programs"]] == ["start[3r]"]
    assert ts["programs"][0]["extra"] == {"max_memory_allocated": None}
    np.testing.assert_allclose(trep.perf_round_ms, last["ms_per_round"])
    assert np.isnan(trep.perf_mfu_est).all()
    assert trep.perf_round_ms.shape == jrep.perf_round_ms.shape
    trows = [JSONLinesReceiver.parse_line(l) for l in open(tpath)]
    jrows = [JJSONLinesReceiver.parse_line(l) for l in open(jpath)]
    assert [sorted(r) for r in trows] == [sorted(r) for r in jrows]
    for t, j in zip(trows, jrows):
        assert sorted(t["perf"]) == sorted(j["perf"]) == ["mfu_est",
                                                          "round_ms"]
        assert t["perf"]["mfu_est"] is None
        assert t["perf"]["round_ms"] == pytest.approx(
            last["ms_per_round"])
    d = trep.to_dict()
    assert d["perf_round_ms"] is not None
    # The manifest's perf block is the summary; the verdict's perf the
    # JAX verdict's keys.
    man = tsim.run_manifest().to_dict()
    assert man["perf"]["last_run"] == ts["last_run"]
    assert man["config"]["perf"] == {"analytic": True, "cost": True,
                                     "timing": True}
    from gossipy_tpu.telemetry.health import _verdict_perf as jverdict
    from gossipy_tpu_torch.telemetry.health import _verdict_perf
    assert sorted(_verdict_perf(tsim)) == sorted(jverdict(jsim))


def test_perf_off_keeps_everything_null(key, tmp_path):
    _, tsim = clique_pair(key, fused_merge="multi")
    tst = tsim.init_nodes()
    path = str(tmp_path / "t.jsonl")
    with JSONLinesReceiver(path) as rx:
        tsim.add_receiver(rx)
        tst, rep = tsim.start(tst, n_rounds=2)
    assert tsim.perf is None and tsim.perf_summary() is None
    assert rep.perf_round_ms is None and rep.perf_mfu_est is None
    assert all(JSONLinesReceiver.parse_line(l)["perf"] is None
               for l in open(path))
    assert tsim.run_manifest().to_dict()["perf"] is None
    from gossipy_tpu_torch.telemetry.health import _verdict_perf
    assert _verdict_perf(tsim) is None


def test_perf_facilities_apart():
    """``PerfConfig(timing=False)``: no rows, a banked report and the
    analytic block; ``PerfConfig(cost=False, analytic=False)``: rows and
    the FLOPs of the last run, no report, no analytic block."""
    a = port_sim(perf=cost.PerfConfig(timing=False))
    b = port_sim(perf=cost.PerfConfig(cost=False, analytic=False))
    ra = a.start(a.init_nodes(), n_rounds=2)[1]
    rb = b.start(b.init_nodes(), n_rounds=2)[1]
    assert ra.perf_round_ms is None and rb.perf_round_ms is not None
    sa, sb = a.perf_summary(), b.perf_summary()
    assert sa["last_run"] is None and len(sa["programs"]) == 1
    assert sa["analytic"] is not None
    assert sb["programs"] == [] and sb["analytic"] is None
    assert sb["last_run"]["flops_per_round"] == \
        sa["analytic"]["flops_per_round"]


@pytest.mark.parametrize("path", ["plain", "per_slot", "multi",
                                  "multi-compact"])
def test_options_on_equal_off(path, tmp_path):
    """One run with ``perf``, ``metrics``, ``ledger`` and ``tracing`` all
    on, one with all off, the same seeds, two ``start`` calls each:
    params, optimizer state, ages, ring and boxes bit for bit, every
    report array equal."""
    fused, compact = PATHS[path]
    runs = []
    for on in (False, True):
        kw = dict(perf=True, metrics=True, tracing=Tracer(),
                  ledger=str(tmp_path / "ledger.jsonl")) if on else \
            dict(ledger=False)
        _, th = _handlers()
        sim = tsimulation.GossipSimulator(
            th, tcore.Topology.random_regular(12, 4, seed=5), small_data(),
            delta=100, drop_prob=0.1, online_prob=0.9,
            fused_merge=fused, compact_deliver=compact,
            probes=ProbeConfig(), draws=TorchDraws(3), device="cpu", **kw)
        st = sim.init_nodes(torch.Generator().manual_seed(3))
        st, r1 = sim.start(st, n_rounds=3)
        st, r2 = sim.start(st, n_rounds=2)
        runs.append((st, tsimulation.SimulationReport.concatenate([r1, r2])))
    (a, ra), (b, rb) = runs
    from gossipy_tpu_torch.checkpoint import flatten_state
    fa, fb = flatten_state(a), flatten_state(b)
    assert sorted(fa) == sorted(fb)
    for k, v in fa.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, fb[k]), k
        else:
            assert v == fb[k], k
    da, db = ra.to_dict(), rb.to_dict()
    assert db["perf_round_ms"] is not None and da["perf_round_ms"] is None
    for k in da:
        if not k.startswith("perf"):
            assert json.dumps(da[k]) == json.dumps(db[k]), k
    assert len(RunLedger(str(tmp_path / "ledger.jsonl")).rows()) == 2


def port_sim(**kw):
    """12 LogReg nodes on ``random_regular(12, 4)`` in the port, on the
    CPU, drawing from ``TorchDraws(3)``."""
    _, th = _handlers()
    return tsimulation.GossipSimulator(
        th, tcore.Topology.random_regular(12, 4, seed=5), small_data(),
        delta=100, draws=TorchDraws(3), device="cpu", **kw)


def _handlers():
    jh = SGDHandler(model=LogisticRegression(10, 2),
                    loss=losses.cross_entropy, optimizer=optax.sgd(0.1),
                    local_epochs=1, batch_size=8, n_classes=2,
                    input_shape=(10,))
    th = TSGDHandler(TLogReg(10, 2), tlosses.cross_entropy,
                     learning_rate=0.1, local_epochs=1, batch_size=8,
                     n_classes=2, input_shape=(10,))
    return jh, th


# -- the phase ranges and the trace reducer -----------------------------------

def test_phase_names_match_jax():
    for name in ("PHASE_SEND", "PHASE_RECEIVE_MERGE", "PHASE_TRAIN",
                 "PHASE_EVAL", "PHASE_REPLY", "ROUND_PHASES"):
        assert getattr(scopes, name) == getattr(jscopes, name), name
    text = "x gossipy.train y gossipy.send"
    assert scopes.phases_in_text(text) == jscopes.phases_in_text(text)


@pytest.mark.parametrize("path", ["plain", "multi"])
def test_profile_dir_trace_holds_the_phases(path, tmp_path):
    """``start(profile_dir=...)`` on the CPU: one Chrome trace in the
    directory holding the four round phases, reduced to a positive time
    for each (route ``cpu``), their sum within the run's wall; the run
    equals an unprofiled one."""
    fused, compact = PATHS[path]
    _, th = _handlers()
    runs = []
    for profiled in (True, False):
        sim = tsimulation.GossipSimulator(
            th, tcore.Topology.random_regular(12, 4, seed=5), small_data(),
            delta=100, fused_merge=fused, compact_deliver=compact,
            draws=TorchDraws(3), device="cpu")
        st = sim.init_nodes(torch.Generator().manual_seed(3))
        t0 = time.perf_counter()
        st, _ = sim.start(st, n_rounds=3,
                          profile_dir=(str(tmp_path / "p") if profiled
                                       else None))
        runs.append((st, time.perf_counter() - t0))
    assert torch.equal(runs[0][0].model.params, runs[1][0].model.params)
    files = os.listdir(tmp_path / "p")
    assert len(files) == 1 and files[0].startswith("GossipSimulator_r0_")
    assert scopes.phases_in_trace_dir(str(tmp_path / "p")) == \
        list(scopes.ROUND_PHASES)
    detail = {}
    ms = cost.phase_times_from_trace(str(tmp_path / "p"), detail=detail)
    assert detail["route"] == "cpu"
    assert sorted(ms) == sorted(scopes.ROUND_PHASES)
    assert min(ms.values()) > 0
    assert sum(ms.values()) <= runs[0][1] * 1e3


def test_profile_dir_bridges_phases_into_the_tracer(tmp_path):
    """With ``tracing=`` the profiled run's phase times are the device
    spans laid under ``engine.run``."""
    tr = Tracer()
    _, th = _handlers()
    sim = tsimulation.GossipSimulator(
        th, tcore.Topology.random_regular(12, 4, seed=5), small_data(),
        delta=100, tracing=tr, device="cpu")
    sim.start(sim.init_nodes(), n_rounds=2, profile_dir=str(tmp_path))
    names = sorted(e["name"] for e in tr.snapshot()["traceEvents"]
                   if e.get("cat") == "device")
    assert names == ["device.eval", "device.receive_merge", "device.send",
                     "device.train"]


def _x(name, cat, ts, dur, pid=1, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, "args": args}


def _write(tmp_path, events, name="t.json", gz=False):
    doc = json.dumps({"traceEvents": events})
    path = tmp_path / name
    if gz:
        with gzip.open(path, "wt") as fh:
            fh.write(doc)
    else:
        path.write_text(doc)
    return str(tmp_path)


# A round on the card: the CPU ranges (send; receive_merge holding train),
# their GPU copies over the kernels, kernels inside and outside the ranges,
# a memcpy in train, a nested op pair and runtime calls on the CPU.
CARD_EVENTS = [
    _x("gossipy.send", "user_annotation", 0, 100),
    _x("gossipy.receive_merge", "user_annotation", 100, 300),
    _x("gossipy.train", "user_annotation", 150, 200),
    _x("gossipy.eval", "user_annotation", 400, 100),
    _x("aten::linear", "cpu_op", 160, 50),
    _x("aten::addmm", "cpu_op", 165, 40),
    _x("cudaLaunchKernel", "cuda_runtime", 10, 5, correlation=1),
    _x("cudaLaunchKernel", "cuda_runtime", 110, 5, correlation=2),
    _x("cudaLaunchKernel", "cuda_runtime", 170, 5, correlation=3),
    _x("cudaMemcpyAsync", "cuda_runtime", 180, 5, correlation=4),
    _x("cudaLaunchKernel", "cuda_runtime", 410, 5, correlation=5),
    _x("cudaLaunchKernel", "cuda_runtime", 600, 5, correlation=6),
    _x("gossipy.send", "gpu_user_annotation", 1000, 40, pid=0, tid=7),
    _x("gossipy.receive_merge", "gpu_user_annotation", 1100, 200, pid=0,
       tid=7),
    _x("gossipy.train", "gpu_user_annotation", 1150, 100, pid=0, tid=7),
    _x("gossipy.eval", "gpu_user_annotation", 1400, 30, pid=0, tid=7),
    _x("send_k", "kernel", 1005, 30, pid=0, tid=7, correlation=1),
    _x("merge_k", "kernel", 1110, 20, pid=0, tid=7, correlation=2),
    _x("train_k", "kernel", 1160, 50, pid=0, tid=7, correlation=3),
    _x("Memcpy HtoD", "gpu_memcpy", 1220, 10, pid=0, tid=7, correlation=4),
    _x("eval_k", "kernel", 1405, 20, pid=0, tid=7, correlation=5),
    _x("stray_k", "kernel", 1600, 70, pid=0, tid=7, correlation=6),
]


def test_trace_reducer_gpu_annotations(tmp_path):
    """Device events summed by the deepest enclosing GPU range: train's
    kernel and copy go to train, not to receive_merge as well; the CPU
    copies of the ranges, the CPU ops and the ranges' own durations are
    not summed; a kernel outside every range goes nowhere."""
    detail = {}
    ms = cost.phase_times_from_trace(_write(tmp_path, CARD_EVENTS),
                                     detail=detail)
    assert detail["route"] == "gpu_user_annotation"
    assert ms == {"gossipy.send": 0.03, "gossipy.receive_merge": 0.02,
                  "gossipy.train": 0.06, "gossipy.eval": 0.02}


def test_trace_reducer_correlation_route(tmp_path):
    """Without GPU ranges, a device event goes to the deepest CPU range
    around the runtime call that launched it (its correlation id)."""
    events = [e for e in CARD_EVENTS if e["cat"] != "gpu_user_annotation"]
    detail = {}
    ms = cost.phase_times_from_trace(_write(tmp_path, events, gz=True,
                                            name="t.json.gz"),
                                     detail=detail)
    assert detail["route"] == "correlation"
    assert detail["file"].endswith("t.json.gz")
    assert ms == {"gossipy.send": 0.03, "gossipy.receive_merge": 0.02,
                  "gossipy.train": 0.06, "gossipy.eval": 0.02}


def test_trace_reducer_cpu_route(tmp_path):
    """A trace without device events: the top-level CPU ops by the
    deepest enclosing CPU range (``aten::addmm`` inside ``aten::linear``
    counts once; ops of another thread go to that thread's ranges)."""
    events = [
        _x("gossipy.send", "user_annotation", 0, 100),
        _x("gossipy.receive_merge", "user_annotation", 100, 300),
        _x("gossipy.train", "user_annotation", 150, 200),
        _x("gossipy.eval", "user_annotation", 400, 100),
        _x("aten::index", "cpu_op", 10, 30),
        _x("aten::gather", "cpu_op", 110, 20),
        _x("aten::linear", "cpu_op", 160, 50),
        _x("aten::addmm", "cpu_op", 165, 40),
        _x("aten::mul", "cpu_op", 220, 10),
        _x("aten::argmax", "cpu_op", 410, 15),
        _x("aten::add", "cpu_op", 600, 40),
        _x("gossipy.train", "user_annotation", 0, 50, tid=2),
        _x("aten::mm", "cpu_op", 5, 20, tid=2),
    ]
    detail = {}
    ms = cost.phase_times_from_trace(_write(tmp_path, events),
                                     detail=detail)
    assert detail["route"] == "cpu"
    assert ms == {"gossipy.send": 0.03, "gossipy.receive_merge": 0.02,
                  "gossipy.train": 0.08, "gossipy.eval": 0.015}


def test_trace_reducer_one_file_and_none(tmp_path):
    """One file's account only (the first in sorted order that holds
    phase work); None for a directory without phase-attributed work."""
    assert cost.phase_times_from_trace(str(tmp_path)) is None
    (tmp_path / "a").mkdir()
    _write(tmp_path / "a", [_x("aten::mm", "cpu_op", 0, 5)], name="0.json")
    (tmp_path / "a" / "junk.json").write_text("{not json")
    assert cost.phase_times_from_trace(str(tmp_path)) is None
    _write(tmp_path / "a", CARD_EVENTS, name="1.json")
    _write(tmp_path / "a", CARD_EVENTS + CARD_EVENTS, name="2.json")
    ms = cost.phase_times_from_trace(str(tmp_path))
    assert ms["gossipy.train"] == 0.06


def test_differential_attribution_sums_to_total():
    """Three legs (full, eval off, two epochs) differenced: train, eval
    and the rest sum to the whole round within 5%."""
    def make(eval_every=1, local_epochs=1):
        th = TSGDHandler(TLogReg(10, 2), tlosses.cross_entropy,
                         learning_rate=0.1, local_epochs=local_epochs,
                         batch_size=8, n_classes=2, input_shape=(10,))
        return tsimulation.GossipSimulator(
            th, tcore.Topology.random_regular(12, 4, seed=5), small_data(),
            delta=100, eval_every=eval_every, device="cpu")
    out = cost.differential_phase_attribution(make, rounds=3)
    assert out["method"] == "differential" and out["rounds"] == 3
    assert sorted(out["phases_ms"]) == ["eval", "exchange_and_overhead",
                                        "train"]
    total = sum(out["phases_ms"].values())
    assert abs(total - out["full_ms"]) <= 0.05 * out["full_ms"]


# -- the sink events -----------------------------------------------------------

@pytest.fixture
def sinks():
    j, t = jsink.TelemetrySink(), sink.TelemetrySink()
    pj, pt = jsink.set_sink(j), sink.set_sink(t)
    yield j, t
    jsink.set_sink(pj)
    sink.set_sink(pt)


def test_mailbox_undersized_event_matches_jax(key, sinks):
    js, ts = sinks
    # clique_pair silences the warnings; the events are sent anyway.
    clique_pair(key, mailbox_slots=1)
    (je,), (te,) = js.events("mailbox_undersized"), \
        ts.events("mailbox_undersized")
    assert sorted(te.data) == sorted(je.data)
    for k, v in je.data.items():
        assert te.data[k] == pytest.approx(v, rel=1e-12), k


def test_probes_summary_event_matches_jax(key, sinks):
    js, ts = sinks
    jsim, tsim = clique_pair(key, fused_merge="multi", probes=True,
                             drop_prob=0.2)
    jst = jsim.init_nodes(key)
    tst = to_port_state(tsim, jst)
    jsim.start(jst, n_rounds=4, key=key)
    tsim.start(tst, n_rounds=4)
    (je,), (te,) = js.events("probes_summary"), ts.events("probes_summary")
    assert sorted(te.data) == sorted(je.data)
    for k in ("simulator", "probes", "stale_max", "accepted_total"):
        assert te.data[k] == je.data[k], k
    for k in ("consensus_first", "consensus_last"):
        assert te.data[k] == pytest.approx(je.data[k], rel=1e-5, abs=1e-6)


class _JPoisoned(jsimulation.GossipSimulator):
    def _pre_send(self, state, base_key, r):
        import jax.numpy as jnp
        p = state.model.params
        b = p["Dense_0"]["bias"]
        b = b.at[5, 0].set(jnp.where(r == 2, jnp.nan, b[5, 0]))
        params = {"Dense_0": {**p["Dense_0"], "bias": b}}
        return state._replace(model=state.model._replace(params=params))


class _TPoisoned(tsimulation.GossipSimulator):
    def _pre_send(self, state, r):
        if r == 2:
            state.model.params[5, 0] = float("nan")


def test_sentinel_trip_event_matches_jax(key, sinks):
    """A live run that trips in round 3: one ``sentinel_trip`` a tripped
    round in each engine, with the same payload; a replayed run sends
    none, as in the JAX engine."""
    js, ts = sinks
    data = small_data()
    adj = np.ones((12, 12), dtype=bool)
    jh, th = _handlers()
    jsim = _JPoisoned(jh, jcore.Topology(adj), data, delta=100,
                      sentinels=True, fused_merge="multi")
    tsim = _TPoisoned(th, tcore.Topology(adj), data, delta=100,
                      sentinels=True, fused_merge="multi",
                      draws=JaxDraws(key, init_key=key), device="cpu")
    for sim in (jsim, tsim):
        sim.add_receiver(CallbackReceiver(lambda row: None, live=True))
    jst = jsim.init_nodes(key)
    tst = to_port_state(tsim, jst)
    jsim.start(jst, n_rounds=4, key=key)
    tsim.start(tst, n_rounds=4)
    jax.effects_barrier()
    jt = sorted((e.data for e in js.events("sentinel_trip")),
                key=lambda d: d["round"])
    tt = [e.data for e in ts.events("sentinel_trip")]
    assert [sorted(d) for d in tt] == [sorted(d) for d in jt]
    assert [(d["round"], d["nonfinite_params"]) for d in tt] == \
        [(d["round"], d["nonfinite_params"]) for d in jt]
    assert tt[0]["round"] == 3
    assert {d["simulator"] for d in tt} == {"_TPoisoned"}


def test_no_sentinel_trip_when_replayed(sinks):
    _, ts = sinks
    _, th = _handlers()
    sim = _TPoisoned(th, tcore.Topology.clique(12), small_data(), delta=100,
                     sentinels=True, device="cpu")
    rep = sim.start(sim.init_nodes(), n_rounds=4)[1]
    assert rep.health_trip.sum() > 0
    assert ts.events("sentinel_trip") == []


# -- the variants take the options as the vanilla engine does -----------------

def _variant(name, **kw):
    """``name``'s port simulator over the configuration its tests use,
    ``kw`` passed to its constructor."""
    from torch_pairs import logreg, pegasos, topology
    from gossipy_tpu_torch.flow_control import RandomizedTokenAccount
    handler = {"PassThroughGossipSimulator": pegasos,
               "CacheNeighGossipSimulator": pegasos,
               "SamplingGossipSimulator": lambda: logreg("sampling"),
               "PartitioningGossipSimulator": lambda: logreg("partitioned"),
               "All2AllGossipSimulator": lambda: logreg("weighted"),
               }.get(name, logreg)()[1]
    if name == "All2AllGossipSimulator":
        kw["mixing"] = tcore.uniform_mixing(topology("ba"))
    if name == "PENSGossipSimulator":
        kw.update(n_sampled=4, m_top=2, step1_rounds=1)
    if name.startswith("Tokenized"):
        kw["token_account"] = RandomizedTokenAccount(C=4, A=2)
    cls = getattr(tsimulation, name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return cls(handler, topology("clique" if name == "PENSGossipSimulator"
                                     else "ba"), small_data(), delta=100,
                   device="cpu", **kw)


VARIANTS = ("PassThroughGossipSimulator", "CacheNeighGossipSimulator",
            "SamplingGossipSimulator", "PartitioningGossipSimulator",
            "PENSGossipSimulator", "TokenizedGossipSimulator",
            "All2AllGossipSimulator")


@pytest.mark.parametrize("name", VARIANTS)
def test_variants_take_the_options(name, tmp_path, monkeypatch):
    """Each variant passes ``perf=``, ``metrics=`` and ``ledger=`` to the
    engine, as the JAX variants do: a run gives its perf rows and summary,
    one ledger row a ``start`` (PENS: one a segment, under one run id) and
    the registry's rounds; ``start(profile_dir=...)`` traces the four
    phases (the neighbour cache's has no train range: its training is
    the cache merge of the send phase, as in the JAX variant)."""
    from gossipy_tpu_torch.telemetry import MetricsRegistry, set_registry
    path = str(tmp_path / "l.jsonl")
    monkeypatch.setenv("GOSSIPY_TPU_LEDGER", "")
    reg = MetricsRegistry()
    prev = set_registry(reg)
    try:
        sim = _variant(name, perf=True, metrics=True, ledger=path)
        assert sim.perf is not None and sim.metrics_enabled
        st = sim.init_nodes()
        st, rep = sim.start(st, n_rounds=3, profile_dir=str(tmp_path / "p"))
    finally:
        set_registry(prev)
    assert rep.perf_round_ms is not None and len(rep.perf_round_ms) == 3
    assert sim.perf_summary()["last_run"]["rounds"] in (1, 2, 3)
    rows = RunLedger(path).rows()
    assert len(rows) == (2 if name == "PENSGossipSimulator" else 1)
    assert len({r["run_id"] for r in rows}) == 1
    series = reg.snapshot()["metrics"]["engine_rounds_total"]["series"]
    assert [s["value"] for s in series] == [3.0]
    want = [p for p in scopes.ROUND_PHASES
            if not (name == "CacheNeighGossipSimulator"
                    and p == scopes.PHASE_TRAIN)]
    assert scopes.phases_in_trace_dir(str(tmp_path / "p")) == want
