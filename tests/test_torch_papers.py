"""The four paper examples on the vanilla simulator, held against the JAX
engine, and the two repairs that carry them.

- Repairs: ``to_device`` keeps a float label float32 (an integer one
  int64), and a ``LinearRegression`` run under ``mse`` on non-integer
  targets matches the JAX engine; the port's default deliver is the
  fused one only for a handler that admits it, and naming a fused path
  for one that does not still raises.
- ``LimitedMergeSGDHandler``'s merge and receive against the JAX
  handler's (age gaps past the threshold either way, within it, two
  age-0 models), params within 1e-5.
- The numpy copies (clustering, regression and rating handlers, the
  rating dispatcher, the synthetic MovieLens loader) array-equal to the
  JAX package's.
- The four configurations, built by the port's twins
  (``gossipy_tpu_torch/examples/main_*.py``) cut to 12-16 nodes and
  by the JAX package's classes on the same arrays, run in both engines
  from the same state under the JAX draw oracle (``torch_pairs``):
  Ormandi (Pegasos) on the plain and the single-pass fused deliver,
  Berta (k-means), Hegedus (MF) and Danner (limited merge) on the plain
  path, wide and compact. Accounting, mailbox, reply box and ages
  exactly; params within 1e-5 (Pegasos's, whose weights reach hundreds,
  within 1e-5 plus 1e-6 of the value); metrics within 1e-5.
- ``run_repetitions``: each repetition bit-equal to the port's own
  ``init_nodes`` + ``start`` from the same seed, and under the oracle
  (the split keys ``k_init, k_run`` of each repetition) equal to the JAX
  ``run_repetitions`` in accounting and params.
"""

import json
import urllib.request
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gossipy_tpu import core as jcore
from gossipy_tpu import data as jdata
from gossipy_tpu.core import CreateModelMode
from gossipy_tpu.handlers import KMeansHandler, LimitedMergeSGDHandler, \
    MFHandler, PegasosHandler, SGDHandler, losses
from gossipy_tpu.handlers.base import PeerModel as JPeerModel
from gossipy_tpu.models import AdaLine, LinearRegression, LogisticRegression
from gossipy_tpu.simulation import GossipSimulator
from gossipy_tpu_torch import convert
from gossipy_tpu_torch import data as tdata
from gossipy_tpu_torch.core import Topology as TTopology
from gossipy_tpu_torch.examples import main_berta_2014 as berta
from gossipy_tpu_torch.examples import main_danner_2023 as danner
from gossipy_tpu_torch.examples import main_hegedus_2020 as hegedus
from gossipy_tpu_torch.examples import main_ormandi_2013 as ormandi
from gossipy_tpu_torch.handlers import KMeansHandler as TKMeansHandler
from gossipy_tpu_torch.handlers import MFHandler as TMFHandler
from gossipy_tpu_torch.handlers import ModelState as TModelState
from gossipy_tpu_torch.handlers import PeerModel as TPeerModel
from gossipy_tpu_torch.handlers import PegasosHandler as TPegasosHandler
from gossipy_tpu_torch.handlers import SGDHandler as TSGDHandler
from gossipy_tpu_torch.handlers import losses as tlosses
from gossipy_tpu_torch.models import AdaLine as TAdaLine
from gossipy_tpu_torch.models import LinearRegression as TLinReg
from gossipy_tpu_torch.models import LogisticRegression as TLogReg
from gossipy_tpu_torch.random import TorchDraws
from gossipy_tpu_torch.simulation import GossipSimulator as TGossipSimulator
from torch_oracle import JaxDraws, perms_from_keys
from torch_pairs import assert_same_run, run_both

torch.set_num_threads(1)

N, ROUNDS = 16, 5
# Pegasos's step is 1 / (t lambda) = 100 / t at lambda 0.01, so its weights
# reach hundreds, where one float32 step is 3e-5: they are held within
# 1e-5 plus 1e-6 of the value (about 8 float32 steps).
PEGASOS_RTOL = 1e-6


def spambase():
    """The port's spambase stand-in (normalised), ``(X, y)``."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return tdata.load_classification_dataset("spambase")


def same_stacked(jd, td):
    assert sorted(jd) == sorted(td)
    for k in jd:
        assert np.asarray(jd[k]).dtype == np.asarray(td[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(td[k]), np.asarray(jd[k]),
                                      err_msg=k)


def jax_sim(jh, tsim, stacked, **kw):
    """The JAX simulator of ``tsim``'s configuration: its topology's
    adjacency, ``stacked``, and ``kw`` in the JAX package's terms."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore",
                                message=r"mailbox_slots=\d+ may overflow")
        return GossipSimulator(jh, jcore.Topology(tsim.topology.adjacency),
                               stacked, **kw)


# -- repairs ------------------------------------------------------------------

def test_to_device_keeps_each_label_kind():
    st = {"xtr": np.zeros((2, 3, 4), np.float64),
          "ytr": np.array([[1.5, -1.0, 3.7], [0.0, 2.25, 1.0]]),
          "yte": np.array([[1, 2], [0, 1]], np.int32),
          "xte": np.array([[4, 5], [6, 7]], np.int32),
          "mtr": np.ones((2, 3), np.float32)}
    on = tdata.to_device(st, "cpu")
    assert on["ytr"].dtype == torch.float32
    np.testing.assert_array_equal(on["ytr"].numpy(),
                                  st["ytr"].astype(np.float32))
    assert on["yte"].dtype == torch.int64
    assert on["xte"].dtype == torch.int32
    assert on["xtr"].dtype == on["mtr"].dtype == torch.float32


def test_float_targets_mse_run_matches_jax_engine():
    """LinearRegression under ``mse`` on non-integer targets: a port that
    truncated them to integers would train on other targets."""
    rng = np.random.default_rng(2)
    X = rng.normal(size=(96, 5)).astype(np.float32)
    y = (X @ rng.normal(size=5) * 0.3 + 1.0).astype(np.float32)
    assert np.abs(y - np.round(y)).max() > 0.1
    stacked = tdata.DataDispatcher(tdata.RegressionDataHandler(
        X, y, test_size=0), n=12).stacked()
    assert stacked["ytr"].dtype == np.float32
    jh = SGDHandler(model=LinearRegression(5, 1), loss=losses.mse,
                    optimizer=optax.sgd(0.05), local_epochs=1, batch_size=4,
                    n_classes=2, input_shape=(5,))
    th = TSGDHandler(TLinReg(5, 1), tlosses.mse, learning_rate=0.05,
                     local_epochs=1, batch_size=4, n_classes=2,
                     input_shape=(5,))
    key = jax.random.PRNGKey(3)
    tsim = TGossipSimulator(th, TTopology.clique(12), stacked, delta=100,
                            fused_merge=False, device="cpu",
                            draws=JaxDraws(key, init_key=key))
    jsim = jax_sim(jh, tsim, stacked, delta=100)
    run_both(jsim, tsim, key, rounds=4, common_init=False)


def port_handlers():
    sgd = dict(local_epochs=1, batch_size=8, n_classes=2, input_shape=(6,))
    merge_update = dict(create_model_mode=CreateModelMode.MERGE_UPDATE)
    return {
        "kmeans": TKMeansHandler(k=2, dim=6, matching="hungarian",
                                 **merge_update),
        "mf": TMFHandler(dim=5, n_items=10, **merge_update),
        "limited": danner.danner_handler(6),
        "pegasos": TPegasosHandler(TAdaLine(6), 0.01, **merge_update),
        "sgd": TSGDHandler(TLogReg(6, 2), tlosses.cross_entropy, **sgd),
        "sgd-update": TSGDHandler(TLogReg(6, 2), tlosses.cross_entropy,
                                  create_model_mode=CreateModelMode.UPDATE,
                                  **sgd),
    }


def tiny_stacked():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(48, 6)).astype(np.float32)
    y = rng.integers(0, 2, 48)
    return tdata.DataDispatcher(tdata.ClassificationDataHandler(
        X, y, test_size=0.25), n=12).stacked()


@pytest.mark.parametrize("name", ["kmeans", "mf", "limited", "pegasos", "sgd",
                                  "sgd-update"])
def test_default_deliver_follows_the_handler(name):
    handler = port_handlers()[name]
    sim = TGossipSimulator(handler, TTopology.clique(12), tiny_stacked(),
                           device="cpu")
    admits = name in ("pegasos", "sgd")
    assert sim.fused_merge == ("multi" if admits else False)
    for fused in ("multi", True, "per_slot"):
        if admits:
            TGossipSimulator(handler, TTopology.clique(12), tiny_stacked(),
                             fused_merge=fused, device="cpu")
        else:
            with pytest.raises(ValueError):
                TGossipSimulator(handler, TTopology.clique(12),
                                 tiny_stacked(), fused_merge=fused,
                                 device="cpu")


# -- limited merge ---------------------------------------------------------

def limited_pair():
    jh = LimitedMergeSGDHandler(
        model=LogisticRegression(6, 2), loss=losses.cross_entropy,
        optimizer=optax.chain(optax.add_decayed_weights(1e-3),
                              optax.sgd(1.0)),
        local_epochs=1, batch_size=4, n_classes=2, input_shape=(6,),
        age_diff_threshold=1, create_model_mode=CreateModelMode.MERGE_UPDATE)
    th = danner.danner_handler(6)
    th.batch_size = 4
    return jh, th


def test_limited_merge_and_call_match_jax():
    jh, th = limited_pair()
    # (own, peer) ages: gaps past the threshold either way, within it, at
    # it, and two age-0 models (the plain-average guard).
    a1 = np.array([9, 0, 3, 4, 0, 2], np.int32)
    a2 = np.array([1, 7, 4, 3, 0, 3], np.int32)
    n = len(a1)
    own = jax.vmap(jh.init)(jax.random.split(jax.random.PRNGKey(1), n))
    peer = jax.vmap(jh.init)(jax.random.split(jax.random.PRNGKey(2), n))
    own = own._replace(n_updates=jnp.asarray(a1))
    jpeer = JPeerModel(peer.params, jnp.asarray(a2))
    to_rows = lambda tree: convert.params_from_jax(
        jax.tree.map(np.asarray, tree), th.layout)
    state = TModelState(to_rows(own.params), th.init_opt_state(
        to_rows(own.params)), torch.from_numpy(a1))
    tpeer = TPeerModel(to_rows(peer.params), torch.from_numpy(a2))
    want = jax.vmap(jh.merge)(own, jpeer)
    got = th.merge(state, tpeer)
    np.testing.assert_allclose(got.params.numpy(),
                               to_rows(want.params).numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got.n_updates.numpy(), np.maximum(a1, a2))
    np.testing.assert_array_equal(got.params[0].numpy(),
                                  state.params[0].numpy())
    np.testing.assert_array_equal(got.params[1].numpy(),
                                  tpeer.params[1].numpy())
    np.testing.assert_allclose(
        got.params[4].numpy(),
        (0.5 * state.params[4] + 0.5 * tpeer.params[4]).numpy(), atol=1e-7)
    rng = np.random.default_rng(3)
    X = rng.normal(size=(n, 8, 6)).astype(np.float32)
    y = rng.integers(0, 2, (n, 8))
    mask = np.ones((n, 8), np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), n)
    want = jax.vmap(jh.call)(own, jpeer, (X, y, mask), keys)
    perms = torch.from_numpy(perms_from_keys(keys, 1, 8)).long()
    got = th.call(state, tpeer, (torch.from_numpy(X), torch.from_numpy(y),
                                 torch.from_numpy(mask)), perms)
    np.testing.assert_allclose(got.params.numpy(),
                               to_rows(want.params).numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got.n_updates.numpy(),
                                  np.asarray(want.n_updates))


# -- the numpy copies --------------------------------------------------------

def no_download(monkeypatch, cache_dir):
    """The JAX loader tries a download before its stand-in: refuse it, and
    keep its archive cache in the test's own directory."""
    def refuse(*a, **k):
        raise OSError("no download in tests")
    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    monkeypatch.setenv("GOSSIPY_TPU_DATA_DIR", str(cache_dir))


@pytest.mark.parametrize("name", ["ml-100k", "ml-1m"])
def test_recsys_loader_and_dispatcher_match_jax(name, monkeypatch, tmp_path):
    no_download(monkeypatch, tmp_path)
    with pytest.warns(UserWarning):
        want = jdata.load_recsys_dataset(name)
    with pytest.warns(UserWarning):
        got = tdata.load_recsys_dataset(name)
    assert got[1:] == want[1:]
    assert got[0] == want[0]
    users = 50 if name == "ml-1m" else want[1]
    jd = jdata.RecSysDataDispatcher(jdata.RecSysDataHandler(
        want[0], users, want[2], test_size=0.1, seed=7)).stacked()
    td = tdata.RecSysDataDispatcher(tdata.RecSysDataHandler(
        got[0], users, got[2], test_size=0.1, seed=7)).stacked()
    same_stacked(jd, td)
    with pytest.raises(FileNotFoundError):
        tdata.load_recsys_dataset(name, allow_synthetic=False)


def test_clustering_and_regression_handlers_match_jax():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(40, 3)).astype(np.float32)
    y = rng.integers(0, 3, 40)
    for eval_on_user in (False, True):
        jd = jdata.DataDispatcher(jdata.ClusteringDataHandler(X, y), n=6,
                                  eval_on_user=eval_on_user).stacked()
        td = tdata.DataDispatcher(tdata.ClusteringDataHandler(X, y), n=6,
                                  eval_on_user=eval_on_user).stacked()
        same_stacked(jd, td)
    yr = rng.normal(size=40)
    j = jdata.RegressionDataHandler(X, yr, test_size=0.25, seed=3)
    t = tdata.RegressionDataHandler(X, yr, test_size=0.25, seed=3)
    for idx, ev in (([0, 3, 5], False), ([1, 2], True)):
        (jx, jy), (tx, ty) = j.at(idx, ev), t.at(idx, ev)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
        assert ty.dtype == jy.dtype == np.float32
    assert t.at([], True) is None and j.at([], True) is None


# -- the four configurations in both engines -------------------------------

def ormandi_pair(key, deliver):
    X, y = spambase()
    td, dim = ormandi.ormandi_data(N, sets=(X[:40], y[:40]))
    jdh = jdata.ClassificationDataHandler(
        X[:40], (2 * y[:40] - 1).astype(np.float32), test_size=0.1, seed=42)
    jd = jdata.DataDispatcher(jdh, n=N, eval_on_user=False).stacked()
    same_stacked(jd, td)
    tsim = ormandi.ormandi_sim(td, dim, draws=JaxDraws(key, init_key=key),
                               device="cpu",
                               fused_merge="multi" if deliver == "multi"
                               else False)
    jh = PegasosHandler(net=AdaLine(dim), learning_rate=0.01,
                        create_model_mode=CreateModelMode.MERGE_UPDATE)
    jsim = jax_sim(jh, tsim, jd, delta=100,
                   protocol=jcore.AntiEntropyProtocol.PUSH,
                   delay=jcore.UniformDelay(0, 10), online_prob=0.2,
                   drop_prob=0.1, sampling_eval=0.1, sync=False,
                   fused_merge=tsim.fused_merge)
    return jsim, tsim


def berta_pair(key, compact):
    X, y = spambase()
    td, dim = berta.berta_data(N, sets=(X[:48], y[:48]))
    jd = jdata.DataDispatcher(jdata.ClusteringDataHandler(X[:48], y[:48]),
                              n=N, eval_on_user=False).stacked()
    same_stacked(jd, td)
    tsim = berta.berta_sim(td, dim, draws=JaxDraws(key, init_key=key),
                           device="cpu", compact_deliver=compact)
    jh = KMeansHandler(k=2, dim=dim, alpha=0.1, matching="hungarian",
                       create_model_mode=CreateModelMode.MERGE_UPDATE)
    jsim = jax_sim(jh, tsim, jd, delta=1000,
                   protocol=jcore.AntiEntropyProtocol.PUSH, drop_prob=0.1,
                   sampling_eval=0.01, sync=True, compact_deliver=compact or
                   False)
    return jsim, tsim


def hegedus_pair(key, compact, monkeypatch, cache_dir):
    no_download(monkeypatch, cache_dir)
    with pytest.warns(UserWarning):
        sets = jdata.load_recsys_dataset("ml-100k")
    users = 12
    td, n_items = hegedus.hegedus_data(users=users)
    jd = jdata.RecSysDataDispatcher(jdata.RecSysDataHandler(
        sets[0], users, sets[2], test_size=0.1, seed=42)).stacked()
    same_stacked(jd, td)
    tsim = hegedus.hegedus_sim(td, n_items, draws=JaxDraws(
        key, init_key=key), device="cpu", compact_deliver=compact)
    jh = MFHandler(dim=5, n_items=n_items, lam_reg=0.1, learning_rate=0.001,
                   create_model_mode=CreateModelMode.MERGE_UPDATE)
    jsim = jax_sim(jh, tsim, jd, delta=100,
                   protocol=jcore.AntiEntropyProtocol.PUSH,
                   delay=jcore.UniformDelay(0, 10), sampling_eval=0.1,
                   sync=True, compact_deliver=compact or False)
    return jsim, tsim


def danner_pair(key, compact):
    X, y = spambase()
    td, dim = danner.danner_data(N, sets=(X[:320], y[:320]))
    jd = jdata.DataDispatcher(jdata.ClassificationDataHandler(
        X[:320], y[:320], test_size=0.1, seed=42), n=N,
        eval_on_user=False).stacked()
    same_stacked(jd, td)
    tsim = danner.danner_sim(td, dim, draws=JaxDraws(key, init_key=key),
                             device="cpu", compact_deliver=compact)
    jh = LimitedMergeSGDHandler(
        model=LogisticRegression(dim, 2), loss=losses.cross_entropy,
        optimizer=optax.chain(optax.add_decayed_weights(1e-3),
                              optax.sgd(1.0)),
        local_epochs=1, batch_size=32, n_classes=2, input_shape=(dim,),
        age_diff_threshold=1, create_model_mode=CreateModelMode.MERGE_UPDATE)
    jsim = jax_sim(jh, tsim, jd, delta=100,
                   protocol=jcore.AntiEntropyProtocol.PUSH,
                   delay=jcore.UniformDelay(0, 10), online_prob=0.2,
                   drop_prob=0.1, sampling_eval=0.1, sync=True,
                   compact_deliver=compact or False)
    return jsim, tsim


@pytest.mark.parametrize("deliver", ["plain", "multi"])
def test_ormandi_matches_jax_engine(deliver):
    key = jax.random.PRNGKey(5)
    jsim, tsim = ormandi_pair(key, deliver)
    assert tsim.fused_merge == ("multi" if deliver == "multi" else False)
    assert tsim.K == jsim.K and tsim.F == 2
    trep = run_both(jsim, tsim, key, rounds=ROUNDS, common_init=False,
                    param_rtol=PEGASOS_RTOL)
    assert trep.sent_messages > 0 and trep.failed_per_cause["offline"].sum()


@pytest.mark.parametrize("compact", [None, 4], ids=["wide", "compact"])
def test_berta_matches_jax_engine(compact):
    key = jax.random.PRNGKey(6)
    jsim, tsim = berta_pair(key, compact)
    assert tsim.fused_merge is False
    trep = run_both(jsim, tsim, key, rounds=ROUNDS, common_init=False)
    assert np.isfinite(trep.curves(False)["nmi"]).all()
    if compact:
        assert trep.compact_slots_per_round.sum() > 0


@pytest.mark.parametrize("compact", [None, 4], ids=["wide", "compact"])
def test_hegedus_matches_jax_engine(compact, monkeypatch, tmp_path):
    key = jax.random.PRNGKey(7)
    jsim, tsim = hegedus_pair(key, compact, monkeypatch, tmp_path)
    assert tsim.fused_merge is False
    trep = run_both(jsim, tsim, key, rounds=ROUNDS, common_init=False)
    assert np.isfinite(trep.curves(True)["rmse"]).all()


@pytest.mark.parametrize("compact", [None, 4], ids=["wide", "compact"])
def test_danner_matches_jax_engine(compact):
    key = jax.random.PRNGKey(8)
    jsim, tsim = danner_pair(key, compact)
    assert tsim.fused_merge is False
    trep = run_both(jsim, tsim, key, rounds=ROUNDS, common_init=False)
    assert np.isfinite(trep.curves(False)["accuracy"]).all()


# -- run_repetitions ---------------------------------------------------------

def test_run_repetitions_equals_own_runs():
    X, y = spambase()
    td, dim = ormandi.ormandi_data(12, sets=(X[:40], y[:40]))
    sim = ormandi.ormandi_sim(td, dim, device="cpu")
    states, reports = sim.run_repetitions(3, [3, 8])
    assert isinstance(sim.draws, TorchDraws) and len(reports) == 2
    for seed, st, rep in zip((3, 8), states, reports):
        own = ormandi.ormandi_sim(td, dim, seed=seed, device="cpu")
        ost = own.init_nodes(torch.Generator().manual_seed(seed))
        ost, orep = own.start(ost, n_rounds=3)
        assert torch.equal(st.model.params, ost.model.params)
        assert torch.equal(st.model.n_updates, ost.model.n_updates)
        np.testing.assert_array_equal(rep.sent_per_round, orep.sent_per_round)
        np.testing.assert_array_equal(rep.failed_per_round,
                                      orep.failed_per_round)
        np.testing.assert_array_equal(rep.curves(False)["accuracy"],
                                      orep.curves(False)["accuracy"])
    assert not torch.equal(states[0].model.params, states[1].model.params)


def test_run_repetitions_matches_jax_under_oracle():
    key = jax.random.PRNGKey(9)
    jsim, tsim = ormandi_pair(key, "plain")
    keys = jax.random.split(key, 2)
    draws = []
    for k in keys:
        k_init, k_run = jax.random.split(k)
        draws.append(JaxDraws(k_run, init_key=k_init))
    jst, jreps = jsim.run_repetitions(3, keys)
    tsts, treps = tsim.run_repetitions(3, [0, 1], draws=draws)
    for i, (tst, trep) in enumerate(zip(tsts, treps)):
        one = jax.tree.map(lambda a: a[i], jst)
        # Pegasos starts from zeros in both packages: params are held too.
        assert_same_run(jsim, tsim, one, tst, jreps[i], trep,
                        param_rtol=PEGASOS_RTOL)


def test_twin_summary_and_plot(tmp_path, capsys):
    """A twin's ``--plot`` saves the curves and its summary line is the
    JAX scripts' (``examples/_common.py::finish``) keys."""
    path = tmp_path / "curves.png"
    out = danner.main(["--device", "cpu", "--nodes", "12", "--rounds", "3",
                       "--plot", str(path)])
    assert path.stat().st_size > 0
    assert sorted(out) == ["failed_messages", "final", "repetitions",
                           "rounds", "sent_messages", "total_size"]
    assert out["rounds"] == 3 and out["sent_messages"] == 36
    assert capsys.readouterr().out.strip().splitlines()[-1] == \
        json.dumps(out)
