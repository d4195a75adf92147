"""The port's experiment configs, held against ``gossipy_tpu.config``.

- ``ExperimentConfig``: the same fields and defaults, the same
  ``TENANT_VARIABLE_FIELDS`` and ``shape_fields()``, the default's
  ``to_json()`` equal as text; every shipped config parses in both, and
  malformed configs raise the same exception types.
- ``build_experiment`` in both packages builds the same simulator: for
  every simulator kind and every task, and for every shipped config (cut
  with ``subsample``): the topology, the shards, the partition's index
  sets, the handler's hyperparameters and the simulator's knobs.
- Built from one config, the gossip, sequential, tokenized and all2all
  simulators of both packages run from the same converted weights under
  the JAX draw oracle with equal accounting and params within 1e-5
  (``torch_pairs``).
- ``run_experiment``: reproducible from a JSON file (a seed gives one
  run, another seed another), ``repetitions`` (the seeds ``seed + i``),
  FEMNIST's writer shards, one node per sample, and the
  ``main_from_config`` twin.

Neither package's loader is called for a UCI or MovieLens name, nor for
FEMNIST, here: the JAX package's tries a download first. Both get the
port's offline stand-in as ``data=``, or the download is blocked.
"""

import dataclasses
import glob
import json
import os
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gossipy_tpu import config as jconfig
from gossipy_tpu import data as jdata
from gossipy_tpu_torch import config as tconfig
from gossipy_tpu_torch import data as tdata
from gossipy_tpu_torch.convert import params_from_jax
from gossipy_tpu_torch.models import CIFAR10Net
from gossipy_tpu_torch.random import TorchDraws
from torch_oracle import JaxDraws
from torch_pairs import assert_same_aux, assert_same_run, \
    assert_same_seq_run, message_logs, seq_to_port_state, to_port_state

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted(glob.glob(str(REPO / "examples" / "configs" / "*.json")))
torch.set_num_threads(1)


def spambase():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return tdata.load_classification_dataset("spambase")


def ratings():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return tdata.load_recsys_dataset("ml-100k")


def tiny_images(shape=(32, 32, 3), c=10):
    """A small synthetic image set in place of the 60,000 images."""
    def get(allow_synthetic=True):
        return (tdata._synthetic_images("tiny-train", 160, shape, c),
                tdata._synthetic_images("tiny-test", 40, shape, c))
    return get


@pytest.fixture
def small_images(monkeypatch):
    for mod in (jdata, tdata):
        monkeypatch.setattr(mod, "get_CIFAR10", tiny_images())
        monkeypatch.setattr(mod, "get_FashionMNIST",
                            tiny_images((28, 28, 1)))


@pytest.fixture
def no_femnist_download(monkeypatch):
    def refuse(*a, **kw):
        raise OSError("no download in the tests")
    monkeypatch.setattr(jdata, "_download_femnist", refuse)


def both(d):
    return jconfig.ExperimentConfig.from_dict(dict(d)), \
        tconfig.ExperimentConfig.from_dict(dict(d))


def build_both(d, data=None):
    jc, tc = both(d)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsim, jdisp = jconfig.build_experiment(jc, data)
        tsim, tdisp = tconfig.build_experiment(tc, data, device="cpu")
    return jsim, tsim, jdisp, tdisp


# -- the dataclass ------------------------------------------------------------

def test_fields_and_defaults_match_jax():
    jf = {f.name: f for f in dataclasses.fields(jconfig.ExperimentConfig)}
    tf = {f.name: f for f in dataclasses.fields(tconfig.ExperimentConfig)}
    assert list(jf) == list(tf)
    assert dataclasses.asdict(jconfig.ExperimentConfig()) == \
        dataclasses.asdict(tconfig.ExperimentConfig())
    for name in jf:
        assert jf[name].type == tf[name].type, name
    assert tconfig.TENANT_VARIABLE_FIELDS == jconfig.TENANT_VARIABLE_FIELDS
    assert tconfig.ExperimentConfig(seed=3).shape_fields() == \
        jconfig.ExperimentConfig(seed=3).shape_fields()


def test_default_json_equal_as_text(tmp_path):
    assert tconfig.ExperimentConfig().to_json() == \
        jconfig.ExperimentConfig().to_json()
    cfg = tconfig.ExperimentConfig(model="mlp",
                                   model_params={"hidden_dims": [16]})
    cfg.to_json(str(tmp_path / "exp.json"))
    assert tconfig.ExperimentConfig.from_json(str(tmp_path / "exp.json")) \
        == cfg
    assert tconfig.ExperimentConfig.from_json('{"n_nodes": 4}').n_nodes == 4


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_shipped_config_parses_in_both(path):
    j = jconfig.ExperimentConfig.from_json(path)
    t = tconfig.ExperimentConfig.from_json(path)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.to_json() == j.to_json()


MALFORMED = [
    {"n_nodez": 4},
    {"repetitions": 0},
    {"task": "regression?"},
    {"task": "recsys", "handler": "sgd"},
    {"handler": "mf"},
    {"cohort": {"size": 4}, "repetitions": 2},
]

BAD_BUILDS = [
    {"topology": "hypercube"},
    {"model": "resnet50"},
    {"simulator": "quantum"},
    {"handler": "adam?"},
    {"loss": "hinge?"},
    {"delay": "exponential"},
    {"model_params": {"oops": 1}},
    {"topology": "clique", "topology_params": {"degree": 2}},
    {"model": "cifar10net", "model_params": {"conv_impl": "fft"}},
    {"simulator": "sequential", "eval_every": 3},
    {"simulator": "tokenized", "token_account": "lavish"},
    {"simulator": "all2all", "simulator_params": {"mixing": "random"}},
    {"sparse_topology": True, "topology": "clique"},
    {"assignment": "by_zodiac"},
    {"chaos": {"outages": [], "typo": 1}},
    {"task": "clustering", "dataset": "cifar10", "handler": "kmeans"},
]


def _raised(fn):
    try:
        fn()
    except Exception as e:  # the type is what is compared
        return type(e).__name__
    return None


@pytest.mark.parametrize("bad", MALFORMED, ids=str)
def test_malformed_config_raises_alike(bad):
    j = _raised(lambda: jconfig.ExperimentConfig.from_dict(bad))
    t = _raised(lambda: tconfig.ExperimentConfig.from_dict(bad))
    assert j is not None and j == t


@pytest.mark.parametrize("bad", BAD_BUILDS, ids=str)
def test_bad_build_raises_alike(bad):
    d = {**BASE, **bad}
    data = spambase() if bad.get("dataset") != "cifar10" else None
    j = _raised(lambda: build_both(d, data))
    t = _raised(lambda: tconfig.build_experiment(
        tconfig.ExperimentConfig.from_dict(d), data, device="cpu"))
    assert j is not None and j == t


def test_cohort_and_cuda(monkeypatch):
    """The cohort field builds a cohort experiment on the CPU (the pool
    and the C-wide rounds of ``run_experiment``); without a card the
    build and the run raise unless ``device="cpu"``."""
    from gossipy_tpu_torch.simulation import CohortPool
    cfg = tconfig.ExperimentConfig(**{**BASE, "n_rounds": 2},
                                   cohort={"size": 4})
    sim, _ = tconfig.build_experiment(cfg, spambase(), device="cpu")
    assert (sim.n_nodes, sim.nominal_n, sim.cohort.size) == (4, 12, 4)
    pool, rep = tconfig.run_experiment(cfg, spambase(), device="cpu")
    assert isinstance(pool, CohortPool) and pool.round == 2
    assert (rep.cohort_active_nodes == 4).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tconfig.build_experiment(cfg, spambase())
    cfg = tconfig.ExperimentConfig(**{**BASE, "n_rounds": 1})
    with pytest.raises(RuntimeError, match="CUDA"):
        tconfig.run_experiment(cfg, spambase())
    _, rep = tconfig.run_experiment(cfg, spambase(), device="cpu")
    assert rep.final("accuracy") == rep.final("accuracy")


def test_cnn_conv_impl_is_configurable():
    """``conv_impl`` takes the JAX model's names (the port lowers every one
    by im2col) and refuses any other, as the JAX model does."""
    for impl in ("auto", "einsum", "conv"):
        m = tconfig._model("cifar10net", {"conv_impl": impl}, 32, 10)
        assert isinstance(m, CIFAR10Net)
    assert isinstance(tconfig._model("cifar10net", {}, 32, 10),
                      CIFAR10Net)
    with pytest.raises(ValueError, match="unknown conv_impl"):
        tconfig._model("cifar10net", {"conv_impl": "fft"}, 32, 10)
    with pytest.raises(ValueError, match="unknown model_params"):
        tconfig._model("cifar10net", {"oops": 1}, 32, 10)


# -- the built simulators -------------------------------------------------------

def _handler_knobs(h):
    out = {"class": type(h).__name__,
           "mode": int(getattr(h, "mode", -1))}
    for a in ("local_epochs", "batch_size", "n_classes", "input_shape",
              "learning_rate", "k", "alpha", "matching", "reg", "lr", "L",
              "sample_size"):
        if hasattr(h, a):
            v = getattr(h, a)
            out[a] = tuple(v) if isinstance(v, (list, tuple)) else v
    if hasattr(h, "compute_dtype"):
        out["bf16"] = "bfloat16" in str(h.compute_dtype)
    return out


def _sim_knobs(sim):
    out = {"class": type(sim).__name__, "handler": _handler_knobs(
        sim.handler)}
    for a in ("n_nodes", "delta", "drop_prob", "online_prob",
              "sampling_eval", "sync", "eval_every", "K", "Kr", "F",
              "history_dtype", "n_sampled", "m_top", "step1_rounds"):
        if hasattr(sim, a):
            out[a] = getattr(sim, a)
    out["protocol"] = int(sim.protocol)
    out["delay"] = repr(sim.delay)
    acc = getattr(sim, "account", None)
    if acc is not None:
        out["account"] = (type(acc).__name__, repr(acc))
    return out


def assert_same_build(jsim, tsim, jdisp, tdisp):
    """The topology, the shards, the partition's index sets, the
    handler's hyperparameters and the simulator's knobs."""
    jk, tk = _sim_knobs(jsim), _sim_knobs(tsim)
    assert jk == tk
    if getattr(jsim, "fused_merge", None) == getattr(tsim, "fused_merge",
                                                     None):
        # The compaction's capacity belongs to the deliver path, whose
        # default differs: the port takes the single pass where the JAX
        # engine takes the plain one.
        assert getattr(jsim, "_compact_cap", None) == \
            getattr(tsim, "_compact_cap", None)
    if hasattr(tsim.topology, "adjacency"):
        np.testing.assert_array_equal(np.asarray(tsim.topology.adjacency),
                                      np.asarray(jsim.topology.adjacency))
    else:
        for a in ("indptr", "indices"):
            np.testing.assert_array_equal(
                np.asarray(getattr(tsim.topology, a)),
                np.asarray(getattr(jsim.topology, a)))
    assert tdisp.size() == jdisp.size()
    jdata_ = jsim.data
    assert sorted(tsim.data) == sorted(jdata_)
    for k in jdata_:
        np.testing.assert_array_equal(tsim.data[k].cpu().numpy(),
                                      np.asarray(jdata_[k]), err_msg=k)
    part = getattr(tsim.handler, "partition", None)
    if part is not None:
        jp = jsim.handler.partition
        assert part.n_parts == jp.n_parts
        np.testing.assert_array_equal(part.sizes, jp.sizes)
        layout = tsim.handler.layout
        ids = params_from_jax(jax.tree.map(np.asarray, jp.part_ids), layout,
                              stacked=False)
        real = torch.arange(layout.stride) < layout.width
        np.testing.assert_array_equal(part.part_of[real].numpy(),
                                      ids[real].long().numpy())
    if hasattr(tsim, "mixing"):
        np.testing.assert_allclose(np.asarray(tsim.mixing.cpu()),
                                   np.asarray(jsim.mixing), rtol=1e-6)


BASE = dict(n_nodes=12, subsample=240, topology="random_regular",
            topology_params={"degree": 4, "seed": 3}, delta=20,
            batch_size=8, learning_rate=0.5, n_rounds=4, test_size=0.25)

KINDS = {
    "gossip": {},
    "gossip-multi-bf16": {"simulator_params": {"fused_merge": "multi",
                                               "history_dtype": "bfloat16"},
                          "weight_decay": 0.01},
    "sequential": {"simulator": "sequential", "token_account": "simple",
                   "token_account_params": {"C": 2}},
    "tokenized": {"simulator": "tokenized", "token_account": "generalized",
                  "token_account_params": {"C": 1, "A": 1}},
    "tokenized_partitioning": {
        "simulator": "tokenized_partitioning", "handler": "partitioned",
        "handler_params": {"n_parts": 3}, "create_model_mode": "UPDATE",
        "token_account": "randomized",
        "token_account_params": {"C": 20, "A": 10}},
    "all2all": {"simulator": "all2all", "handler": "weighted",
                "simulator_params": {"mixing": "metropolis"}},
    "passthrough": {"simulator": "passthrough", "handler": "pegasos",
                    "learning_rate": 0.01, "sync": False},
    "cache_neigh": {"simulator": "cache_neigh"},
    "sampling": {"simulator": "sampling", "handler": "sampling",
                 "handler_params": {"sample_size": 0.25}},
    "partitioning": {"simulator": "partitioning", "handler": "partitioned",
                     "handler_params": {"n_parts": 2}},
    "pens": {"simulator": "pens", "topology": "clique",
             "topology_params": {},
             "simulator_params": {"n_sampled": 4, "m_top": 2,
                                  "step1_rounds": 2}},
    "limited_merge": {"handler": "limited_merge", "delay": "uniform",
                      "delay_params": {"min_delay": 0, "max_delay_": 10},
                      "drop_prob": 0.1, "online_prob": 0.5,
                      "sampling_eval": 0.25},
    "sparse": {"sparse_topology": True, "protocol": "PUSH_PULL"},
    "clustering": {"task": "clustering", "handler": "kmeans",
                   "handler_params": {"k": 2, "alpha": 0.1,
                                      "matching": "hungarian"},
                   "topology": "clique", "topology_params": {}},
    "adaline": {"handler": "adaline", "learning_rate": 0.01,
                "assignment": "label_dirichlet_skew",
                "assignment_params": {"beta": 0.5}},
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_build_matches_jax(kind):
    d = {**BASE, **KINDS[kind]}
    jsim, tsim, jdisp, tdisp = build_both(d, spambase())
    assert_same_build(jsim, tsim, jdisp, tdisp)


def test_build_recsys_matches_jax():
    d = dict(task="recsys", dataset="ml-100k", handler="mf",
             handler_params={"dim": 4, "lam_reg": 0.1}, learning_rate=0.01,
             topology_params={"degree": 8, "seed": 0}, delta=10,
             sampling_eval=0.2, n_rounds=2)
    jsim, tsim, jdisp, tdisp = build_both(d, ratings())
    assert_same_build(jsim, tsim, jdisp, tdisp)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_shipped_config_builds_alike(path, small_images):
    """Every shipped config (the tabular ones cut to 200 samples, the
    image ones on a small stand-in set) builds the same simulator in both
    packages."""
    cfg = json.load(open(path))
    data = None
    if cfg.get("task") == "recsys":
        data = ratings()
    elif cfg.get("dataset") == "spambase":
        data = spambase()
        cfg["subsample"] = 200
    cfg["n_rounds"] = 2
    jsim, tsim, jdisp, tdisp = build_both(cfg, data)
    assert_same_build(jsim, tsim, jdisp, tdisp)


# -- the built simulators run alike under the oracle ----------------------------

@pytest.mark.parametrize("kind", ["gossip", "gossip-multi-bf16", "tokenized",
                                  "all2all", "sequential"])
def test_config_run_matches_jax(kind):
    """The two config-built simulators from the same converted weights,
    under the JAX draw oracle: accounting exact, params within 1e-5 (the
    bf16 ring within one encoding step more). Each pair runs one deliver
    path: the JAX engine's default (plain) unless the config names one."""
    d = {**BASE, **KINDS[kind]}
    if kind in ("gossip", "tokenized"):
        d["simulator_params"] = {"fused_merge": False}
    jsim, tsim, _, _ = build_both(d, spambase())
    key = jax.random.PRNGKey(d.get("seed", 42))
    rounds = 4
    if kind == "sequential":
        run_key = jax.random.fold_in(key, 1)
        tsim.draws = JaxDraws(run_key, init_key=key)
        jlog, tlog = message_logs()
        jsim.add_receiver(jlog)
        tsim.add_receiver(tlog)
        jst = jsim.init_nodes(key)
        tst = seq_to_port_state(tsim, jst)
        jst, jrep = jsim.start(jst, n_rounds=rounds, key=run_key)
        tst, trep = tsim.start(tst, n_rounds=rounds)
        assert_same_seq_run(jsim, tsim, jst, tst, jrep, trep, jlog, tlog)
        return
    assert tsim.fused_merge == jsim.fused_merge or kind == "all2all"
    tsim.draws = JaxDraws(key, init_key=key)
    jst = jsim.init_nodes(key)
    tst = to_port_state(tsim, jst)
    jst, jrep = jsim.start(jst, n_rounds=rounds, key=key, donate_state=False)
    tst, trep = tsim.start(tst, n_rounds=rounds)
    assert_same_run(jsim, tsim, jst, tst, jrep, trep)
    if kind == "tokenized":
        assert_same_aux(tsim, jst, tst)
    assert int(np.sum(trep.sent_per_round)) > 0


# -- running --------------------------------------------------------------------

def test_run_from_json_reproducible(tmp_path):
    """One config file gives one run (the seed keys the draws and the
    weights); another seed gives another."""
    cfg = tconfig.ExperimentConfig(**BASE)
    path = tmp_path / "exp.json"
    cfg.to_json(str(path))
    runs = [tconfig.run_experiment(tconfig.ExperimentConfig.from_json(
        str(path)), spambase(), device="cpu") for _ in range(2)]
    (s1, r1), (s2, r2) = runs
    assert torch.equal(s1.model.params, s2.model.params)
    np.testing.assert_array_equal(r1.curves(local=False)["accuracy"],
                                  r2.curves(local=False)["accuracy"])
    np.testing.assert_array_equal(r1.sent_per_round, r2.sent_per_round)
    s3, _ = tconfig.run_experiment(dataclasses.replace(cfg, seed=7),
                                   spambase(), device="cpu")
    assert not torch.equal(s1.model.params, s3.model.params)


def test_repetitions_run_the_seed_rule():
    """``repetitions=3`` runs the seeds ``seed, seed + 1, seed + 2``: each
    repetition equals the single run of its seed."""
    cfg = tconfig.ExperimentConfig(**{**BASE, "n_rounds": 3,
                                      "repetitions": 3, "seed": 5})
    assert tconfig.repetition_seeds(cfg) == [5, 6, 7]
    states, reports = tconfig.run_experiment(cfg, spambase(), device="cpu")
    assert len(states) == len(reports) == 3
    # Repetition 1: the config's data (seed 5), weights and draws of 6.
    sim, _ = tconfig.build_experiment(cfg, spambase(), device="cpu")
    sim.draws = TorchDraws(6)
    one = sim.init_nodes(torch.Generator().manual_seed(6))
    one, _ = sim.start(one, n_rounds=3)
    assert torch.equal(states[1].model.params, one.model.params)
    assert not torch.equal(states[0].model.params, states[1].model.params)
    seq = dataclasses.replace(cfg, simulator="sequential", repetitions=2,
                              n_rounds=2)
    states, reports = tconfig.run_experiment(seq, spambase(), device="cpu")
    assert len(reports) == 2 and all(
        np.isfinite(r.curves(local=False)["accuracy"]).all()
        for r in reports)


def test_femnist_writer_shards(no_femnist_download):
    """FEMNIST: the writers' own ragged shards, the same in both (the
    JAX package's test builds it and runs nothing)."""
    d = dict(dataset="femnist", n_nodes=10, model="mlp",
             model_params={"hidden_dims": [16]}, eval_on_user=True,
             topology="ring", topology_params={"k": 2}, delta=10,
             n_rounds=1)
    jsim, tsim, jdisp, tdisp = build_both(d)
    assert tdisp.size() == 10
    assert len({len(a) for a in tdisp.tr_assignments}) > 1
    assert_same_build(jsim, tsim, jdisp, tdisp)
    # A dense model over images: flax's Dense takes the last axis.
    assert tsim.handler.layout.leaves[1] == ("Dense_0/kernel", (1, 16))


def test_one_node_per_sample():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(60, 6)).astype(np.float32)
    y = (X @ rng.normal(size=6) > 0).astype(np.int64)
    cfg = tconfig.ExperimentConfig(n_nodes=0, handler="pegasos",
                                   learning_rate=0.01, topology="clique",
                                   topology_params={}, test_size=0.25,
                                   delta=10, n_rounds=1)
    sim, disp = tconfig.build_experiment(cfg, (X, y), device="cpu")
    assert sim.n_nodes == disp.size() == 45   # one per TRAIN sample


def test_main_from_config(tmp_path, capsys):
    """``--dump-default`` prints the JAX package's default JSON; a config
    file runs end to end and prints the one-line summary."""
    from gossipy_tpu_torch.examples import main_from_config
    main_from_config.main(["--dump-default"])
    assert capsys.readouterr().out.strip() == \
        jconfig.ExperimentConfig().to_json()
    rng = np.random.default_rng(0)
    X = rng.normal(size=(240, 6)).astype(np.float32)
    y = (X @ rng.normal(size=6) > 0).astype(np.int64)
    lines = "\n".join(" ".join([str(int(t))] + [f"{j + 1}:{v:.6f}"
                                                 for j, v in enumerate(x)])
                      for x, t in zip(X, y))
    (tmp_path / "data.svm").write_text(lines + "\n")
    cfg = tconfig.ExperimentConfig(**{**BASE, "subsample": 0,
                                      "dataset": str(tmp_path / "data.svm"),
                                      "n_rounds": 3})
    cfg.to_json(str(tmp_path / "exp.json"))
    out = main_from_config.main([str(tmp_path / "exp.json"), "--device",
                                 "cpu"])
    assert out["rounds"] == 3 and out["sent_messages"] > 0
    assert json.loads(capsys.readouterr().out.strip()) == out
