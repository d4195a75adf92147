"""The four paper examples on the variant simulators, held against the
JAX engine.

Each configuration is built by the port's twin
(``gossipy_tpu_torch/examples/main_giaretta_2019.py``,
``main_hegedus_2021.py``, ``main_all2all.py``) cut to 24 nodes (Giaretta;
12 for the others) and by the JAX package's classes on the same arrays,
and run in both engines from the same state under the JAX draw oracle:

- Giaretta 2019 (Pegasos on ``barabasi_albert(n, 10)``, async PUSH) in
  its three variants: vanilla on the single-pass fused deliver in both
  engines, pass-through and neighbour cache on the plain path;
- Hegedus 2021 (LogReg under UPDATE, ``UniformDelay(0, 10)``): the
  partitioned exchange under a token account that lets nodes send from
  the first rounds (``RandomizedTokenAccount(C=2, A=1)``; the example's
  ``C=20, A=10`` sends nothing before round 10), and the sampled one;
- All2All (weighted LogReg, uniform mixing, async).

Accounting, mailbox, reply box, ages and ``aux`` exactly; params within
1e-5 (Pegasos's within 1e-5 plus 1e-6 of the value); metrics within 1e-5.
Onoszko 2021 (PENS on CIFAR10Net) has its own file,
``test_torch_onoszko.py``.
"""

import warnings

import jax
import numpy as np
import optax
import pytest
import torch

from gossipy_tpu import core as jcore
from gossipy_tpu import data as jdata
from gossipy_tpu import flow_control as jflow
from gossipy_tpu import simulation as jsimulation
from gossipy_tpu.compression import ModelPartition as JModelPartition
from gossipy_tpu.core import CreateModelMode
from gossipy_tpu.handlers import PartitionedSGDHandler, PegasosHandler, \
    SamplingSGDHandler, WeightedSGDHandler, losses
from gossipy_tpu.models import AdaLine, LogisticRegression
from gossipy_tpu_torch import data as tdata
from gossipy_tpu_torch import flow_control as tflow
from gossipy_tpu_torch.examples import main_all2all as all2all
from gossipy_tpu_torch.examples import main_giaretta_2019 as giaretta
from gossipy_tpu_torch.examples import main_hegedus_2021 as hegedus
from torch_oracle import JaxDraws
from torch_pairs import PEGASOS_RTOL, assert_same_aux, assert_same_run, \
    to_port_state

torch.set_num_threads(1)

ROUNDS = 5


def spambase():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return tdata.load_classification_dataset("spambase")


def same_stacked(jd, td):
    assert sorted(jd) == sorted(td)
    for k in jd:
        np.testing.assert_array_equal(np.asarray(td[k]), np.asarray(jd[k]),
                                      err_msg=k)


def jax_stacked(X, y, n):
    dh = jdata.ClassificationDataHandler(X, y, test_size=0.1, seed=42)
    return jdata.DataDispatcher(dh, n=n, eval_on_user=False).stacked()


def run(jsim, tsim, key, common_init=False, rtol=0.0):
    jst0 = jsim.init_nodes(key, common_init=common_init)
    tst = to_port_state(tsim, jst0)
    jst, jrep = jsim.start(jst0, n_rounds=ROUNDS, key=key,
                           donate_state=False)
    tst, trep = tsim.start(tst, n_rounds=ROUNDS)
    assert_same_run(jsim, tsim, jst, tst, jrep, trep, param_rtol=rtol)
    assert_same_aux(tsim, jst, tst, rtol=rtol)
    assert trep.sent_messages > 0
    return tst, trep


JAX_GIARETTA = {"vanilla": "GossipSimulator",
                "passthrough": "PassThroughGossipSimulator",
                "cacheneigh": "CacheNeighGossipSimulator"}


@pytest.mark.parametrize("variant", sorted(JAX_GIARETTA))
def test_giaretta_matches_jax_engine(variant):
    X, y = spambase()
    n = 24
    td, dim = giaretta.giaretta_data(n, sets=(X[:40], y[:40]))
    jd = jax_stacked(X[:40], (2 * y[:40] - 1).astype(np.float32), n)
    same_stacked(jd, td)
    key = jax.random.PRNGKey(31)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=r"mailbox_slots=")
        tsim = giaretta.giaretta_sim(td, dim, variant,
                                     draws=JaxDraws(key, init_key=key),
                                     device="cpu")
        jh = PegasosHandler(net=AdaLine(dim), learning_rate=0.01,
                            create_model_mode=CreateModelMode.MERGE_UPDATE)
        jsim = getattr(jsimulation, JAX_GIARETTA[variant])(
            jh, jcore.Topology.barabasi_albert(n, 10, seed=42,
                                               backend="networkx"),
            jd, delta=100, protocol=jcore.AntiEntropyProtocol.PUSH,
            sampling_eval=0.1, sync=False, fused_merge=tsim.fused_merge)
    assert tsim.fused_merge == ("multi" if variant == "vanilla" else False)
    np.testing.assert_array_equal(tsim.topology.adjacency,
                                  jsim.topology.adjacency)
    tst, _ = run(jsim, tsim, key, rtol=PEGASOS_RTOL)
    if variant == "cacheneigh":
        assert tst.aux["cache_valid"].any()


@pytest.mark.parametrize("variant", ["partitioning", "sampling"])
def test_hegedus2021_matches_jax_engine(variant):
    X, y = spambase()
    n = 12
    td, dim = hegedus.hegedus2021_data(n, sets=(X[:240], y[:240]))
    jd = jax_stacked(X[:240], y[:240], n)
    same_stacked(jd, td)
    key = jax.random.PRNGKey(32)
    account = tflow.RandomizedTokenAccount(C=2, A=1)
    tsim = hegedus.hegedus2021_sim(td, dim, variant,
                                   draws=JaxDraws(key, init_key=key),
                                   device="cpu", token_account=account)
    common = dict(model=LogisticRegression(dim, 2),
                  loss=losses.cross_entropy,
                  optimizer=optax.chain(optax.add_decayed_weights(1e-3),
                                        optax.sgd(1.0)),
                  local_epochs=1, batch_size=32, n_classes=2,
                  input_shape=(dim,), create_model_mode=CreateModelMode.UPDATE)
    net = dict(delta=100, protocol=jcore.AntiEntropyProtocol.PUSH,
               delay=jcore.UniformDelay(0, 10), sampling_eval=0.1,
               sync=True)
    topo = jcore.Topology(tsim.topology.adjacency)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=r"mailbox_slots=")
        if variant == "partitioning":
            template = LogisticRegression(dim, 2).init(
                jax.random.PRNGKey(0), np.zeros((1, dim)))["params"]
            jsim = jsimulation.TokenizedPartitioningGossipSimulator(
                PartitionedSGDHandler(JModelPartition(template, 4),
                                      **common), topo, jd,
                token_account=jflow.RandomizedTokenAccount(C=2, A=1), **net)
        else:
            jsim = jsimulation.SamplingGossipSimulator(
                SamplingSGDHandler(0.25, **common), topo, jd, **net)
    assert tsim.fused_merge is False
    tst, _ = run(jsim, tsim, key, common_init=True)
    if variant == "partitioning":
        assert tst.model.n_updates.shape == (n, 4)


def test_all2all_matches_jax_engine():
    X, y = spambase()
    n = 12
    td, dim = all2all.all2all_data(n, sets=(X[:240], y[:240]))
    jd = jax_stacked(X[:240], y[:240], n)
    same_stacked(jd, td)
    key = jax.random.PRNGKey(33)
    tsim = all2all.all2all_sim(td, dim, "uniform",
                               draws=JaxDraws(key, init_key=key),
                               device="cpu")
    topo = jcore.Topology(tsim.topology.adjacency)
    jh = WeightedSGDHandler(
        model=LogisticRegression(dim, 2), loss=losses.cross_entropy,
        optimizer=optax.chain(optax.add_decayed_weights(1e-2),
                              optax.sgd(0.1)),
        local_epochs=1, batch_size=32, n_classes=2, input_shape=(dim,),
        create_model_mode=CreateModelMode.MERGE_UPDATE)
    jsim = jsimulation.All2AllGossipSimulator(
        jh, topo, jd, mixing=jcore.uniform_mixing(topo), delta=100,
        protocol=jcore.AntiEntropyProtocol.PUSH, sampling_eval=0.1,
        sync=False)
    run(jsim, tsim, key, common_init=True)


def test_all2all_unported_flags_raise():
    """The twin's ``--probes``, ``--sentinels`` and ``--chaos`` raised
    until the port took them over; now each runs and its summary entry
    appears (``test_torch_isolation.py`` holds the entries' keys to the
    JAX scripts')."""
    entry = {"--probes": "probes", "--sentinels": "health",
             "--chaos": "chaos"}
    for flag, key in entry.items():
        out = all2all.main(["--device", "cpu", "--nodes", "12", "--rounds",
                            "3", flag])
        assert key in out, (flag, out)
        assert not (set(entry.values()) - {key}) & set(out), (flag, out)
