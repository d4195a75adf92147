"""The port's round, held against the JAX engine's (fused_merge="multi").

Both engines start from the same state (the JAX ``init_nodes`` result,
converted) and consume the same draws (the JAX draw oracle). Per round:
sent and failed-by-cause counts and the mailbox written by the send phase
are equal exactly; parameters within 1e-5 (fp32, reduction order of the
local SGD differs); ages exactly; metrics within 1e-6.

The JAX CNN round program is a compile the suite marks slow, so the
engine is held on LogisticRegression here; the CNN's forward is held in
``test_torch_models.py``.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gossipy_tpu.core import AntiEntropyProtocol, Topology
from gossipy_tpu.data import ClassificationDataHandler, DataDispatcher
from gossipy_tpu.handlers import SGDHandler, losses
from gossipy_tpu.models import LogisticRegression
from gossipy_tpu.simulation import GossipSimulator
from gossipy_tpu_torch import core as tcore
from gossipy_tpu_torch import ops as tops
from gossipy_tpu_torch.convert import params_from_jax, params_to_numpy
from gossipy_tpu_torch.handlers import ModelState as TModelState
from gossipy_tpu_torch.handlers import SGDHandler as TSGDHandler
from gossipy_tpu_torch.handlers import losses as tlosses
from gossipy_tpu_torch.models import LogisticRegression as TLogReg
from gossipy_tpu_torch.simulation import GossipSimulator as TGossipSimulator
from torch_oracle import JaxDraws

torch.set_num_threads(1)

N, K, D_FEAT, ROUNDS = 12, 4, 10, 4


def hub_adjacency(n):
    """Nodes 1..n-1 can only reach node 0: its mailbox overflows."""
    a = np.zeros((n, n), dtype=bool)
    a[1:, 0] = True
    a[0, 1:] = True
    return a


def data():
    rng = np.random.default_rng(11)
    X = rng.normal(size=(24 * N, D_FEAT)).astype(np.float32)
    y = (X @ rng.normal(size=D_FEAT) > 0).astype(np.int64)
    disp = DataDispatcher(ClassificationDataHandler(X, y, test_size=0.25,
                                                    seed=1), n=N)
    return disp.stacked()


def make_pair(adjacency, key, **kw):
    stacked = data()
    jh = SGDHandler(model=LogisticRegression(D_FEAT, 2),
                    loss=losses.cross_entropy, optimizer=optax.sgd(0.1),
                    local_epochs=1, batch_size=8, n_classes=2,
                    input_shape=(D_FEAT,))
    th = TSGDHandler(TLogReg(D_FEAT, 2), tlosses.cross_entropy,
                     learning_rate=0.1, local_epochs=1, batch_size=8,
                     n_classes=2, input_shape=(D_FEAT,))
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore",
                                message=r"mailbox_slots=\d+ may overflow")
        jsim = GossipSimulator(jh, Topology(adjacency), stacked, delta=100,
                               protocol=AntiEntropyProtocol.PUSH,
                               fused_merge="multi", mailbox_slots=K, **kw)
        tsim = TGossipSimulator(th, tcore.Topology(adjacency), stacked,
                                delta=100, mailbox_slots=K,
                                draws=JaxDraws(key, init_key=key),
                                device="cpu", **kw)
    return jsim, tsim


def to_port_state(tsim, jst):
    params = params_from_jax(jax.tree.map(np.asarray, jst.model.params),
                             tsim.handler.layout)
    n_up = torch.as_tensor(np.array(jst.model.n_updates))
    return tsim.init_state(TModelState(params, n_up),
                           torch.as_tensor(np.array(jst.phase)))


def assert_params_close(tst, jst, layout, atol=1e-5):
    got = params_to_numpy(tst.model.params, layout)
    want = {"Dense_0/" + k: np.asarray(v)
            for k, v in jst.model.params["Dense_0"].items()}
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=atol,
                                   err_msg=name)
    np.testing.assert_array_equal(tst.model.n_updates.numpy(),
                                  np.asarray(jst.model.n_updates))


@pytest.mark.parametrize("topology,drop,online", [
    ("clique", 0.0, 1.0),
    ("clique", 0.2, 0.8),
    ("hub", 0.0, 1.0),
])
def test_rounds_match_jax_engine(topology, drop, online):
    adjacency = (np.ones((N, N), dtype=bool) if topology == "clique"
                 else hub_adjacency(N))
    key = jax.random.PRNGKey(3)
    jsim, tsim = make_pair(adjacency, key, drop_prob=drop,
                           online_prob=online)
    layout = tsim.handler.layout
    jst = jsim.init_nodes(key, common_init=True)
    tst = to_port_state(tsim, jst)
    assert_params_close(tst, jst, layout, atol=0)

    seen = []
    deliver = tsim._deliver_phase

    def recording_deliver(state, r):
        seen.append([t.clone() for t in state.mailbox])
        return deliver(state, r)

    tsim._deliver_phase = recording_deliver
    causes = {"drop": 0, "offline": 0, "overflow": 0}
    for r in range(ROUNDS):
        # The JAX mailbox between send and deliver, computed eagerly.
        snap = jsim._snapshot(jst, jnp.int32(r))
        sent_state, *_ = jsim._send_phase(snap, key, jnp.int32(r))
        jst, jrep = jsim.start(jst, n_rounds=1, key=key, donate_state=False)
        tst, trep = tsim.start(tst, n_rounds=1)

        for got, want in zip(seen[-1], sent_state.mailbox):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(trep.sent_per_round,
                                      jrep.sent_per_round)
        np.testing.assert_array_equal(trep.failed_per_round,
                                      jrep.failed_per_round)
        for cause in causes:
            np.testing.assert_array_equal(trep.failed_per_cause[cause],
                                          jrep.failed_per_cause[cause])
            causes[cause] += int(trep.failed_per_cause[cause].sum())
        np.testing.assert_array_equal(trep.wide_slots_per_round,
                                      jrep.wide_slots_per_round)
        np.testing.assert_array_equal(trep.mailbox_hwm_per_round,
                                      jrep.mailbox_hwm_per_round)
        assert trep.total_size == jrep.total_size
        assert_params_close(tst, jst, layout)
        for local in (True, False):
            tc, jc = trep.curves(local), jrep.curves(local)
            assert sorted(tc) == sorted(jc)
            for m in jc:
                np.testing.assert_allclose(tc[m], jc[m], rtol=0, atol=1e-6,
                                           err_msg=m)
    assert trep.final("accuracy") == pytest.approx(jrep.final("accuracy"),
                                                   abs=1e-6)
    # The cases exercise the cause they are there for.
    if drop:
        assert causes["drop"] > 0 and causes["offline"] > 0
    if topology == "hub":
        assert causes["overflow"] > 0


def test_cpu_run_launches_no_kernel():
    tops.reset_launch_counts()
    key = jax.random.PRNGKey(0)
    _, tsim = make_pair(np.ones((N, N), dtype=bool), key)
    st = tsim.init_nodes(common_init=True)
    st, rep = tsim.start(st, n_rounds=2)
    assert rep.sent_messages > 0
    assert tops.LAUNCHES["gather_merge_multi"] == 0


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    """Without a card every entry point raises unless device='cpu'."""
    from gossipy_tpu_torch.data import to_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    th = TSGDHandler(TLogReg(D_FEAT, 2), tlosses.cross_entropy,
                     input_shape=(D_FEAT,))
    with pytest.raises(RuntimeError, match="CUDA"):
        th.init()
    with pytest.raises(RuntimeError, match="CUDA"):
        to_device(data())
    with pytest.raises(RuntimeError, match="CUDA"):
        TGossipSimulator(th, tcore.Topology.clique(N), data(),
                         mailbox_slots=K)
    assert th.init(device="cpu").params.device.type == "cpu"


@pytest.mark.parametrize("option", [
    {"fused_merge": False}, {"fused_merge": "per_slot"},
    {"history_dtype": "bfloat16"}, {"protocol": tcore.AntiEntropyProtocol.PULL},
    {"sync": False}, {"delay": tcore.ConstantDelay(5)}, {"mesh": object()},
    {"chaos": {}}, {"probes": True}, {"sentinels": True},
    {"compact_deliver": True}, {"cohort": 4},
])
def test_unported_options_raise(option):
    th = TSGDHandler(TLogReg(D_FEAT, 2), tlosses.cross_entropy,
                     input_shape=(D_FEAT,))
    with pytest.raises(NotImplementedError):
        TGossipSimulator(th, tcore.Topology.clique(N), data(),
                         mailbox_slots=K, device="cpu", **option)


def test_pretraining_matches_jax_init_nodes():
    """``init_nodes``' local pre-training pass, under the oracle's replay
    of the JAX init keys, gives the JAX ``init_nodes`` params from the same
    initial weights."""
    key = jax.random.PRNGKey(5)
    jsim, tsim = make_pair(np.ones((N, N), dtype=bool), key)
    jst = jsim.init_nodes(key, common_init=True)
    k_init = jax.random.split(key, 3)[0]
    one = jax.tree.map(np.asarray, jsim.handler.init(k_init).params)
    layout = tsim.handler.layout
    params = params_from_jax(one, layout, stacked=False).repeat(N, 1)
    perms = tsim.draws.init_permutations(N, 1, tsim.data["mtr"].shape[1],
                                         tsim.device)
    got = tsim.handler.update(
        TModelState(params, torch.zeros(N, dtype=torch.int32)),
        tsim._local_data(), perms)
    tst = tsim.init_state(got, tsim.draws.init_phase(N, 100, tsim.device))
    assert_params_close(tst, jst, layout)
    np.testing.assert_array_equal(tst.phase.numpy(), np.asarray(jst.phase))


@pytest.mark.parametrize("common", [True, False])
def test_init_nodes_state(common):
    _, tsim = make_pair(np.ones((N, N), dtype=bool), jax.random.PRNGKey(0))
    st = tsim.init_nodes(common_init=common, local_train=False)
    layout = tsim.handler.layout
    assert st.model.params.shape == (N, layout.stride)
    assert (st.model.params[:, layout.width:] == 0).all()
    rows_equal = bool((st.model.params == st.model.params[:1]).all())
    assert rows_equal == common
    assert st.history_params.shape == (2, N, layout.stride)
    assert (st.history_params == st.model.params).all()
    assert (st.mailbox.sender == -1).all() and st.round == 0
    assert ((st.phase >= 0) & (st.phase < 100)).all()
    trained = tsim.init_nodes(common_init=common)
    # 18 real rows per node in batches of 8: three counted updates.
    assert (trained.model.n_updates == 3).all()
