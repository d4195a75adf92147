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

import warnings

import jax
import numpy as np
import optax
import torch

from gossipy_tpu import core as jcore
from gossipy_tpu.data import ClassificationDataHandler, DataDispatcher
from gossipy_tpu.handlers import SGDHandler, losses
from gossipy_tpu.models import LogisticRegression
from gossipy_tpu.simulation import GossipSimulator
from gossipy_tpu_torch import core as tcore
from gossipy_tpu_torch.convert import flatten_names, opt_state_from_jax, \
    params_from_jax, params_to_numpy
from gossipy_tpu_torch.handlers import ModelState as TModelState
from gossipy_tpu_torch.handlers import SGDHandler as TSGDHandler
from gossipy_tpu_torch.handlers import losses as tlosses
from gossipy_tpu_torch.models import LogisticRegression as TLogReg
from gossipy_tpu_torch.simulation import GossipSimulator as TGossipSimulator
from torch_oracle import JaxDraws

N, D_FEAT, ROUNDS = 12, 10, 6

# The deliver paths: (fused_merge, compact_deliver). At N = 12 the plain
# path's automatic compaction is off (it needs N >= 48), so an explicit
# capacity of 4 puts the compacted pass (and its overflow to the wide
# pass) in the run.
PATHS = {"plain": (False, None), "plain-compact": (False, 4),
         "per_slot": ("per_slot", None), "multi": ("multi", None),
         "multi-compact": ("multi", 4)}


def small_data():
    rng = np.random.default_rng(11)
    X = rng.normal(size=(24 * N, D_FEAT)).astype(np.float32)
    y = (X @ rng.normal(size=D_FEAT) > 0).astype(np.int64)
    disp = DataDispatcher(ClassificationDataHandler(X, y, test_size=0.25,
                                                    seed=1), n=N)
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
    jkw = dict(kw)
    if "delay" in kw:
        jkw["delay"] = to_jax_delay(kw["delay"])
    if "protocol" in kw:
        jkw["protocol"] = jcore.AntiEntropyProtocol(int(kw["protocol"]))
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


def assert_same_accounting(jsim, tsim, jst, tst, jrep, trep):
    """The per-round accounting, both boxes, the ages and the ring's
    ages, exactly."""
    assert tsim.K == jsim.K and tsim.Kr == jsim.Kr
    for field in ("sent_per_round", "failed_per_round",
                  "mailbox_hwm_per_round", "compact_slots_per_round",
                  "wide_slots_per_round"):
        np.testing.assert_array_equal(getattr(trep, field),
                                      getattr(jrep, field), err_msg=field)
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
                    metric_tol=1e-5, param_rtol=0.0):
    """The per-round accounting, both boxes, params, ages and metrics;
    params within ``param_tol`` plus ``param_rtol`` of the value (for
    weights far above 1, where 1e-5 is below one float32 step)."""
    assert_same_accounting(jsim, tsim, jst, tst, jrep, trep)
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
