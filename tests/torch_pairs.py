"""One configuration in both engines, run from the same state under the
JAX draw oracle, and the comparison of the two runs.

Both engines start from the same state (the JAX ``init_nodes`` result,
converted) and consume the same draws (``torch_oracle.JaxDraws``). After a
run: sent, failed by cause, the mailbox high-water mark, the compact/wide
slot counts and the total size are equal round by round; the mailbox and
the reply box (every cell, the cells of later rounds included) are equal;
params within ``param_tol`` (fp32 reduction order differs), ages equal;
metrics within ``metric_tol``. A quantized ring adds one encoding step to
the params' tolerance (after an update the two frameworks' params differ
by ~1e-7, and a value that close to a rounding boundary encodes one step
apart, as ``test_torch_engine.py`` sets out): half a bfloat16 step of the
value, or half an int8 quantum of the leaf; its metrics are not compared.
"""

import dataclasses
import functools
import warnings

import jax
import numpy as np
import optax
import torch

from gossipy_tpu import core as jcore
from gossipy_tpu import flow_control as jflow
from gossipy_tpu import simulation as jsimulation
from gossipy_tpu.compression import ModelPartition as JModelPartition
from gossipy_tpu.core import CreateModelMode
from gossipy_tpu.data import ClassificationDataHandler, DataDispatcher
from gossipy_tpu.handlers import PartitionedSGDHandler, PegasosHandler, \
    SamplingSGDHandler, SGDHandler, WeightedSGDHandler, losses
from gossipy_tpu.models import AdaLine, LogisticRegression
from gossipy_tpu.simulation import GossipSimulator
from gossipy_tpu.simulation import faults as jfaults
from gossipy_tpu.telemetry import health as jhealth
from gossipy_tpu.telemetry import probes as jprobes
from gossipy_tpu_torch import core as tcore
from gossipy_tpu_torch import handlers as th
from gossipy_tpu_torch import simulation as tsimulation
from gossipy_tpu_torch.compression import ModelPartition
from gossipy_tpu_torch.convert import flatten_names, opt_state_from_jax, \
    params_from_jax, params_to_numpy
from gossipy_tpu_torch.handlers import ModelState as TModelState
from gossipy_tpu_torch.handlers import SGDHandler as TSGDHandler
from gossipy_tpu_torch.handlers import losses as tlosses
from gossipy_tpu_torch.models import AdaLine as TAdaLine
from gossipy_tpu_torch.models import LogisticRegression as TLogReg
from gossipy_tpu_torch.models.nn import ParamLayout
from gossipy_tpu_torch.optim import add_decayed_weights, chain, sgd
from gossipy_tpu_torch.simulation import GossipSimulator as TGossipSimulator
from gossipy_tpu_torch.simulation import faults as tfaults
from gossipy_tpu_torch.telemetry import health as thealth
from gossipy_tpu_torch.telemetry import probes as tprobes
from torch_oracle import JaxDraws

N, D_FEAT, ROUNDS = 12, 10, 6
# Pegasos's weights reach hundreds (its step is 100 / t at lambda 0.01):
# held within 1e-5 plus 1e-6 of the value.
PEGASOS_RTOL = 1e-6

# The deliver paths: (fused_merge, compact_deliver). At N = 12 the plain
# path's automatic compaction is off (it needs N >= 48), so an explicit
# capacity of 4 puts the compacted pass (and its overflow to the wide
# pass) in the run.
PATHS = {"plain": (False, None), "plain-compact": (False, 4),
         "per_slot": ("per_slot", None), "multi": ("multi", None),
         "multi-compact": ("multi", 4)}


def small_data(signed=False, n=N):
    """``n`` (12) nodes of a linearly separable 10-feature set, 24 samples
    a node (labels 0/1, or ±1 floats when ``signed``)."""
    rng = np.random.default_rng(11)
    X = rng.normal(size=(24 * n, D_FEAT)).astype(np.float32)
    y = (X @ rng.normal(size=D_FEAT) > 0).astype(np.int64)
    if signed:
        y = (2 * y - 1).astype(np.float32)
    disp = DataDispatcher(ClassificationDataHandler(X, y, test_size=0.25,
                                                    seed=1), n=n)
    return disp.stacked()


def handlers(d_feat, batch):
    """LogReg under SGD 0.1, one local epoch, in both packages."""
    jh = SGDHandler(model=LogisticRegression(d_feat, 2),
                    loss=losses.cross_entropy, optimizer=optax.sgd(0.1),
                    local_epochs=1, batch_size=batch, n_classes=2,
                    input_shape=(d_feat,))
    th = TSGDHandler(TLogReg(d_feat, 2), tlosses.cross_entropy,
                     learning_rate=0.1, local_epochs=1, batch_size=batch,
                     n_classes=2, input_shape=(d_feat,))
    return jh, th


def to_jax_delay(delay):
    if isinstance(delay, tcore.UniformDelay):
        return jcore.UniformDelay(delay.min_delay, delay.max_delay_)
    if isinstance(delay, tcore.LinearDelay):
        return jcore.LinearDelay(delay.timexunit, delay.overhead)
    return jcore.ConstantDelay(delay.delay)


def make_pair(jtopo, ttopo, jdata, tdata, key, d_feat=D_FEAT, batch=8,
              **kw):
    """The same configuration in both engines. ``kw`` is given in the
    port's terms (its delay objects and protocol enum) and translated."""
    jh, th = handlers(d_feat, batch)
    jkw = jax_kw(kw)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore",
                                message=r"mailbox_slots=\d+ may overflow")
        jsim = GossipSimulator(jh, jtopo, jdata, delta=100, **jkw)
        tsim = TGossipSimulator(th, ttopo, tdata, delta=100,
                                draws=JaxDraws(key, init_key=key),
                                device="cpu", **kw)
    return jsim, tsim


def clique_pair(key, **kw):
    adj = np.ones((N, N), dtype=bool)
    data = small_data()
    return make_pair(jcore.Topology(adj), tcore.Topology(adj), data, data,
                     key, **kw)


def to_port_state(tsim, jst):
    """The JAX state's params, optimizer state (none for a handler
    without an optimizer), ages and phases, in a round-0 port state."""
    layout = tsim.handler.layout
    params = params_from_jax(jax.tree.map(np.asarray, jst.model.params),
                             layout)
    rule = getattr(tsim.handler, "optimizer", None)
    opt = () if rule is None else opt_state_from_jax(
        jax.tree.map(np.asarray, jst.model.opt_state), layout, rule)
    n_up = torch.as_tensor(np.array(jst.model.n_updates))
    return tsim.init_state(TModelState(params, opt, n_up),
                           torch.as_tensor(np.array(jst.phase)))


def assert_same_accounting(jsim, tsim, jst, tst, jrep, trep,
                           same_path=True):
    """The per-round accounting, both boxes, the ages and the ring's
    ages, exactly. ``same_path=False`` (a port run on another deliver
    path than the JAX run's) holds the compact and wide slot counts by
    their sum."""
    assert tsim.K == jsim.K and tsim.Kr == jsim.Kr
    for field in ("sent_per_round", "failed_per_round",
                  "mailbox_hwm_per_round", "compact_slots_per_round",
                  "wide_slots_per_round"):
        if not same_path and "slots" in field:
            continue
        np.testing.assert_array_equal(getattr(trep, field),
                                      getattr(jrep, field), err_msg=field)
    if not same_path:
        np.testing.assert_array_equal(
            trep.compact_slots_per_round + trep.wide_slots_per_round,
            jrep.compact_slots_per_round + jrep.wide_slots_per_round)
    for cause in ("drop", "offline", "overflow"):
        np.testing.assert_array_equal(trep.failed_per_cause[cause],
                                      jrep.failed_per_cause[cause],
                                      err_msg=cause)
    assert trep.total_size == jrep.total_size
    for name in ("mailbox", "reply_box"):
        for got, want, f in zip(getattr(tst, name), getattr(jst, name),
                                ("sender", "send_round", "msg_type",
                                 "extra")):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"{name}.{f}")
    np.testing.assert_array_equal(tst.model.n_updates.numpy(),
                                  np.asarray(jst.model.n_updates))
    np.testing.assert_array_equal(tst.history_ages.numpy(),
                                  np.asarray(jst.history_ages))


def assert_same_run(jsim, tsim, jst, tst, jrep, trep, param_tol=1e-5,
                    metric_tol=1e-5, param_rtol=0.0, same_path=True):
    """The per-round accounting, both boxes, params, ages and metrics;
    params within ``param_tol`` plus ``param_rtol`` of the value (for
    weights far above 1, where 1e-5 is below one float32 step)."""
    assert_same_accounting(jsim, tsim, jst, tst, jrep, trep, same_path)
    got = params_to_numpy(tst.model.params, tsim.handler.layout)
    wire = tsim.history_dtype
    scales = (flatten_names(jst.history_scale) if wire == "int8" else {})
    for k, v in flatten_names(jst.model.params).items():
        want = np.asarray(v)
        tol = param_tol + param_rtol * np.abs(want)
        if wire == "bfloat16":
            tol = tol + 2.0 ** -8 * np.abs(want)
        elif wire == "int8":
            tol = tol + 0.5 * float(np.asarray(scales[k]).max())
        diff = np.abs(got[k] - want)
        assert (diff <= tol).all(), (k, float(diff.max()))
    if wire != "float32":
        return
    for local in (True, False):
        if not (jsim.has_local_test if local else jsim.has_global_eval):
            continue
        tc, jc = trep.curves(local), jrep.curves(local)
        assert sorted(tc) == sorted(jc)
        for m in jc:
            np.testing.assert_allclose(tc[m], jc[m], rtol=0, atol=metric_tol,
                                       err_msg=m)


def run_both(jsim, tsim, key, rounds=ROUNDS, common_init=True, **tol):
    """``rounds`` rounds in each engine from the JAX ``init_nodes`` state;
    asserts :func:`assert_same_run` and returns the port's report."""
    jst = jsim.init_nodes(key, common_init=common_init)
    tst = to_port_state(tsim, jst)
    jst, jrep = jsim.start(jst, n_rounds=rounds, key=key,
                           donate_state=False)
    tst, trep = tsim.start(tst, n_rounds=rounds)
    assert_same_run(jsim, tsim, jst, tst, jrep, trep, **tol)
    return trep


# -- the simulator variants (nodes.py, variants.py) in both engines -----------

def topology(kind):
    if kind == "ba":
        return tcore.Topology.barabasi_albert(N, 3, seed=3)
    if kind == "clique":
        return tcore.Topology.clique(N)
    return tcore.Topology.random_regular(N, 4, seed=5)


def pegasos():
    return (PegasosHandler(net=AdaLine(D_FEAT), learning_rate=0.01,
                           create_model_mode=CreateModelMode.MERGE_UPDATE),
            th.PegasosHandler(TAdaLine(D_FEAT), 0.01,
                              create_model_mode=CreateModelMode.MERGE_UPDATE))


def logreg(kind="sgd", mode=CreateModelMode.MERGE_UPDATE):
    """LogReg under weight decay 1e-3 and SGD 0.5, batch 8, in both
    packages: ``kind`` sgd, weighted, sampling (0.25) or partitioned (3
    parts)."""
    common = dict(local_epochs=1, batch_size=8, n_classes=2,
                  input_shape=(D_FEAT,), create_model_mode=mode)
    jcommon = dict(model=LogisticRegression(D_FEAT, 2),
                   loss=losses.cross_entropy,
                   optimizer=optax.chain(optax.add_decayed_weights(1e-3),
                                         optax.sgd(0.5)), **common)
    tmodel = TLogReg(D_FEAT, 2)
    tcommon = dict(loss=th.losses.cross_entropy,
                   optimizer=chain(add_decayed_weights(1e-3), sgd(0.5)),
                   **common)
    if kind == "sampling":
        return (SamplingSGDHandler(0.25, **jcommon),
                th.SamplingSGDHandler(0.25, tmodel, **tcommon))
    if kind == "partitioned":
        template = LogisticRegression(D_FEAT, 2).init(
            jax.random.PRNGKey(0), np.zeros((1, D_FEAT)))["params"]
        return (PartitionedSGDHandler(JModelPartition(template, 3),
                                      **jcommon),
                th.PartitionedSGDHandler(
                    ModelPartition(ParamLayout(tmodel.leaves), 3), tmodel,
                    **tcommon))
    jcls, tcls = {"sgd": (SGDHandler, th.SGDHandler),
                  "weighted": (WeightedSGDHandler,
                               th.WeightedSGDHandler)}[kind]
    return jcls(**jcommon), tcls(tmodel, **tcommon)


def jax_kw(kw):
    """``kw`` in the JAX package's terms."""
    out = dict(kw)
    if "delay" in kw:
        out["delay"] = to_jax_delay(kw["delay"])
    if "protocol" in kw:
        out["protocol"] = jcore.AntiEntropyProtocol(int(kw["protocol"]))
    if "token_account" in kw:
        acc = kw["token_account"]
        out["token_account"] = getattr(jflow, type(acc).__name__)(
            **dataclasses.asdict(acc))
    # The telemetry configs: the same fields in the JAX package's classes.
    if isinstance(kw.get("probes"), tprobes.ProbeConfig):
        out["probes"] = jprobes.ProbeConfig(**kw["probes"].to_dict())
    if isinstance(kw.get("sentinels"), thealth.SentinelConfig):
        out["sentinels"] = jhealth.SentinelConfig(**kw["sentinels"].to_dict())
    if isinstance(kw.get("chaos"), tfaults.ChaosConfig):
        out["chaos"] = jfaults.ChaosConfig.from_dict(kw["chaos"].to_dict())
    return out


def jax_topology(topo):
    """The JAX package's topology of the port's ``topo``: the same dense
    adjacency, or the same CSR arrays (rebuilt from the undirected
    pairs)."""
    if isinstance(topo, tcore.SparseTopology):
        pairs = np.stack(tfaults._undirected_pairs(topo), axis=1)
        return jcore.SparseTopology(topo.num_nodes, pairs)
    return jcore.Topology(topo.adjacency)


def make(name, handlers, topo, data, key, mixing=None, **kw):
    """The variant ``name`` in both engines over ``topo`` (dense or
    sparse): ``(jsim, tsim)``."""
    jh, thd = handlers
    jtopo = jax_topology(topo)
    jextra, textra = {}, {}
    if mixing is not None:
        jextra["mixing"] = getattr(jcore, mixing)(jtopo)
        textra["mixing"] = getattr(tcore, mixing)(topo)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=r"mailbox_slots=")
        warnings.filterwarnings("ignore", message=r"PENS n_sampled")
        jsim = getattr(jsimulation, name)(jh, jtopo, data, delta=100,
                                          **jextra, **jax_kw(kw))
        tsim = getattr(tsimulation, name)(
            thd, topo, data, delta=100, draws=JaxDraws(key, init_key=key),
            device="cpu", **textra, **kw)
    return jsim, tsim


def wire_values(tsim, stored, scales):
    """Parked wire rows ``[N, S, stride]`` decoded to float32 names."""
    out = stored.to(torch.float32)
    if scales is not None:
        out = out * scales[..., tsim._col_leaf]
    return {k: v.numpy() for k, v in tsim.handler.layout.views(out).items()}


def assert_same_aux(tsim, jst, tst, tol=1e-5, rtol=0.0):
    """Every ``aux`` entry of the two runs: integers and masks exactly,
    floats (infinities included) within ``tol`` plus ``rtol`` of the
    value, parked models by leaf after decoding."""
    jaux = jst.aux if isinstance(jst.aux, dict) else {}
    assert sorted(tst.aux) == sorted(jaux)
    wire = tsim.history_dtype
    for k, jv in jaux.items():
        if k == "cache_scale":
            continue
        if k == "cache_params":
            scales = None
            want = {n: np.asarray(v, np.float32)
                    for n, v in flatten_names(jv).items()}
            if wire == "int8":
                scales = tst.aux["cache_scale"]
                js = {n: np.asarray(v) for n, v in
                      flatten_names(jst.aux["cache_scale"]).items()}
                want = {n: w * js[n].reshape(js[n].shape + (1,) * (
                    w.ndim - 2)) for n, w in want.items()}
            got = wire_values(tsim, tst.aux[k], scales)
            for n, w in want.items():
                t = tol + rtol * np.abs(w)
                if wire == "int8":
                    t = t + js[n].max()
                elif wire == "bfloat16":
                    t = t + 2.0 ** -7 * np.abs(w)
                g = got[n].reshape(w.shape)
                assert (np.abs(g - w) <= t).all(), (k, n)
            continue
        want = np.asarray(jv)
        got = tst.aux[k].numpy()
        assert got.shape == want.shape, k
        if want.dtype.kind == "f":
            np.testing.assert_array_equal(np.isinf(got), np.isinf(want),
                                          err_msg=k)
            fin = np.isfinite(want)
            np.testing.assert_allclose(got[fin], want[fin], rtol=rtol,
                                       atol=tol, err_msg=k)
        else:
            np.testing.assert_array_equal(got, want.astype(got.dtype),
                                          err_msg=k)


def run_port(tsim, jst0, rounds):
    """``rounds`` rounds of the port from the JAX state ``jst0``."""
    tst = to_port_state(tsim, jst0)
    assert_same_aux(tsim, jst0, tst)
    return tsim.start(tst, n_rounds=rounds)


@functools.lru_cache(maxsize=None)
def reference(build, key_seed: int, rounds: int, common_init: bool = True):
    """One JAX run of ``build()``'s configuration, made once a process:
    ``(jsim, initial state, final state, report)``; each port path is
    held against it."""
    key = jax.random.PRNGKey(key_seed)
    jsim, _ = build(key)
    jst0 = jsim.init_nodes(key, common_init=common_init)
    jst, jrep = jsim.start(jst0, n_rounds=rounds, key=key,
                           donate_state=False)
    return jsim, jst0, jst, jrep


def check_variant(build, key_seed, rounds, common_init=True, rtol=0.0,
                  **port_kw):
    """The port's run of ``build``'s configuration (with ``port_kw``: its
    deliver path) from the JAX reference's initial state, held against
    the reference: the accounting (slot counts by their sum when the
    paths differ), both boxes, ages, params and ``aux``. Returns the
    port's final state and report."""
    jsim, jst0, jst, jrep = reference(build, key_seed, rounds, common_init)
    _, tsim = build(jax.random.PRNGKey(key_seed), **port_kw)
    tst, trep = run_port(tsim, jst0, rounds)
    same = (tsim.fused_merge == (jsim.fused_merge or False)
            and tsim._compact_cap == jsim._compact_cap)
    assert_same_run(jsim, tsim, jst, tst, jrep, trep, param_rtol=rtol,
                    same_path=same)
    assert_same_aux(tsim, jst, tst, rtol=rtol)
    assert trep.sent_messages > 0
    return tsim, tst, trep


# -- probes, sentinels and chaos ---------------------------------------------

# Per-round telemetry arrays of the two reports (the JAX report's field
# names): integers equal, floats within a relative tolerance.
TELEMETRY_FIELDS = tuple(
    f for f in ("probe_consensus_mean", "probe_consensus_max",
                "probe_consensus_per_layer", "probe_stale_mean",
                "probe_stale_max", "probe_stale_hist",
                "probe_accepted_per_node", "probe_merge_delta",
                "probe_train_delta", "health_nonfinite_params",
                "health_nonfinite_delta", "health_nonfinite_metrics",
                "health_first_bad_slot", "health_mix_nonfinite",
                "health_diverged_per_node", "health_param_norm_max",
                "health_delta_norm", "health_delta_hwm",
                "health_mailbox_hwm_run", "health_trip",
                "chaos_component_gap", "chaos_within_mean",
                "chaos_active_components"))


def assert_same_telemetry(jrep, trep, rtol=1e-5, atol=1e-6,
                          skip=()) -> list:
    """Every probe, health and chaos array of the two reports: present
    in both or in neither; integer arrays equal, float arrays within
    ``atol`` plus ``rtol`` of the value (NaN where the other is NaN);
    the static layer names, the expected fan-in and ``failed_chaos``
    equal. Returns the names of the arrays compared."""
    seen = []
    for f in TELEMETRY_FIELDS:
        want, got = getattr(jrep, f), getattr(trep, f)
        assert (want is None) == (got is None), f
        if want is None or f in skip:
            continue
        want, got = np.asarray(want), np.asarray(got)
        assert got.shape == want.shape, (f, got.shape, want.shape)
        if want.dtype.kind in "iub":
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                       equal_nan=True, err_msg=f)
        seen.append(f)
    for f in ("probe_layer_names", "health_layer_names"):
        assert getattr(trep, f) == getattr(jrep, f), f
    if jrep.probe_expected_fanin is not None:
        np.testing.assert_allclose(trep.probe_expected_fanin,
                                   jrep.probe_expected_fanin, rtol=1e-12)
    assert sorted(trep.failed_per_cause) == sorted(jrep.failed_per_cause)
    if "chaos" in jrep.failed_per_cause:
        np.testing.assert_array_equal(trep.failed_per_cause["chaos"],
                                      jrep.failed_per_cause["chaos"])
    return seen


# -- the sequential engine ---------------------------------------------------

class MessageLog:
    """A receiver mixin keeping every per-message event as ``(failed, t,
    round, sender, receiver, type, size)`` and every replayed round's
    ``update_message`` and failure causes."""

    def __init__(self):
        self.events, self.rounds = [], []

    def update_single_message(self, failed, msg):
        self.events.append((bool(failed), msg.t, msg.round, msg.sender,
                            msg.receiver, int(msg.msg_type), msg.size))

    def update_message(self, round, sent, failed, size):
        self.rounds.append((round, sent, failed, size))

    def update_failure_causes(self, round, causes):
        self.rounds.append((round, dict(causes)))


def message_logs():
    """A :class:`MessageLog` receiver for each package: ``(jax, port)``."""
    class JaxLog(MessageLog, jsimulation.SimulationEventReceiver):
        pass

    class PortLog(MessageLog, tsimulation.SimulationEventReceiver):
        pass
    return JaxLog(), PortLog()


def stack_models(models):
    """The JAX sequential engine's ``List[ModelState]`` as one stacked
    state of numpy leaves."""
    return jax.tree.map(lambda *ls: np.stack([np.asarray(a) for a in ls]),
                        *models)


def seq_to_port_state(tsim, jst):
    """The JAX sequential state (its per-node models stacked, its phases
    and balances) as the port's round-0 ``SeqState``."""
    stacked = stack_models(jst.models)
    layout = tsim.handler.layout
    params = params_from_jax(stacked.params, layout)
    rule = getattr(tsim.handler, "optimizer", None)
    opt = () if rule is None else opt_state_from_jax(stacked.opt_state,
                                                     layout, rule)
    n_up = torch.as_tensor(np.asarray(stacked.n_updates))
    return tsim.init_state(TModelState(params, opt, n_up), jst.phase,
                           jst.balance)


def seq_pair(handlers_, topo, data, key, delta=20, **kw):
    """The sequential engine of both packages over ``topo`` with the
    port's ``kw`` translated, the port drawing from the oracle of the run
    key ``fold_in(key, 1)`` and init key ``key``; each with a
    :class:`MessageLog`. Returns ``(jsim, tsim, jlog, tlog)``."""
    jh, thd = handlers_
    run_key = jax.random.fold_in(key, 1)
    jsim = jsimulation.SequentialGossipSimulator(
        jh, jax_topology(topo), data, delta=delta, **jax_kw(kw))
    tsim = tsimulation.SequentialGossipSimulator(
        thd, topo, data, delta=delta, draws=JaxDraws(run_key, init_key=key),
        device="cpu", **kw)
    jlog, tlog = message_logs()
    jsim.add_receiver(jlog)
    tsim.add_receiver(tlog)
    return jsim, tsim, jlog, tlog


def assert_same_seq_run(jsim, tsim, jst, tst, jrep, trep, jlog, tlog,
                        param_tol=1e-5, param_rtol=0.0, metric_tol=1e-5):
    """Two sequential runs: the message streams, the replayed rounds, the
    per-round accounting and causes, the total size, the balances, the
    phases and the ages exactly; params within ``param_tol`` plus
    ``param_rtol`` of the value; the metric curves within
    ``metric_tol``; the probe, health and chaos arrays as
    :func:`assert_same_telemetry` holds them. ``jlog`` None: the
    message logs are not compared."""
    if jlog is not None:
        assert tlog.events == jlog.events
        assert tlog.rounds == jlog.rounds
    assert tst.round == jst.round
    for field in ("sent_per_round", "failed_per_round"):
        np.testing.assert_array_equal(getattr(trep, field),
                                      getattr(jrep, field), err_msg=field)
    assert sorted(trep.failed_per_cause) == sorted(jrep.failed_per_cause)
    for cause, want in jrep.failed_per_cause.items():
        np.testing.assert_array_equal(trep.failed_per_cause[cause], want,
                                      err_msg=cause)
    assert trep.total_size == jrep.total_size
    np.testing.assert_array_equal(tst.phase, np.asarray(jst.phase))
    if jst.balance is None:
        assert tst.balance is None
    else:
        np.testing.assert_array_equal(tst.balance, np.asarray(jst.balance))
    stacked = stack_models(jst.models)
    np.testing.assert_array_equal(tst.model.n_updates.numpy(),
                                  stacked.n_updates)
    got = params_to_numpy(tst.model.params, tsim.handler.layout)
    for k, v in flatten_names(stacked.params).items():
        want = np.asarray(v)
        diff = np.abs(got[k] - want)
        assert (diff <= param_tol + param_rtol * np.abs(want)).all(), \
            (k, float(diff.max()))
    for local in (True, False):
        if not (jsim.has_local_test if local else jsim.has_global_eval):
            continue
        tc, jc = trep.curves(local), jrep.curves(local)
        assert sorted(tc) == sorted(jc)
        for m in jc:
            np.testing.assert_allclose(tc[m], jc[m], rtol=0, atol=metric_tol,
                                       err_msg=m)
    assert_same_telemetry(jrep, trep)
