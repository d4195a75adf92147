"""The port's round, held against the JAX engine's.

Both engines start from the same state (the JAX ``init_nodes`` result,
converted) and consume the same draws (the JAX draw oracle). Per round:
sent and failed-by-cause counts, the compact/wide slot counts and the
mailbox written by the send phase are equal exactly; parameters within
1e-5 (fp32, reduction order of the local SGD differs); ages exactly;
metrics within 1e-6. Each deliver path (``fused_merge`` False, "per_slot"
and "multi", wide and compact) is held against the same path of the JAX
engine, never against another: at fan-in > 1 the paths differ by design.

Quantized rings: the first encode is bit-equal (``test_torch_wire.py``),
but after an update the two frameworks' params differ by about 1e-7, and
a value that close to a rounding boundary encodes one step apart. So a
bfloat16 run is held within 1e-5 plus half a bfloat16 step of the value
(2^-8 |x|), and an int8 run within 1e-5 plus half an int8 quantum of the
leaf (0.5 amax / 127, the step after the 0.5 blend).

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

from gossipy_tpu.core import AntiEntropyProtocol, CreateModelMode, Topology
from gossipy_tpu.data import ClassificationDataHandler, DataDispatcher
from gossipy_tpu.handlers import SGDHandler, losses
from gossipy_tpu.models import LogisticRegression
from gossipy_tpu.simulation import GossipSimulator
from gossipy_tpu_torch import core as tcore
from gossipy_tpu_torch import ops as tops
from gossipy_tpu_torch import optim as toptim
from gossipy_tpu_torch.convert import opt_state_from_jax, params_from_jax, \
    params_to_numpy
from gossipy_tpu_torch.handlers import ModelState as TModelState
from gossipy_tpu_torch.handlers import SGDHandler as TSGDHandler
from gossipy_tpu_torch.handlers import losses as tlosses
from gossipy_tpu_torch.models import LogisticRegression as TLogReg
from gossipy_tpu_torch.random import TorchDraws
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


def make_pair(adjacency, key, fused="multi", rules=None, **kw):
    """``rules``: the (optax, port) optimizers, SGD 0.1 by default."""
    stacked = data()
    jopt, topt = rules if rules is not None else (optax.sgd(0.1),
                                                  toptim.sgd(0.1))
    jh = SGDHandler(model=LogisticRegression(D_FEAT, 2),
                    loss=losses.cross_entropy, optimizer=jopt,
                    local_epochs=1, batch_size=8, n_classes=2,
                    input_shape=(D_FEAT,))
    th = TSGDHandler(TLogReg(D_FEAT, 2), tlosses.cross_entropy,
                     optimizer=topt, local_epochs=1, batch_size=8,
                     n_classes=2, input_shape=(D_FEAT,))
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore",
                                message=r"mailbox_slots=\d+ may overflow")
        jsim = GossipSimulator(jh, Topology(adjacency), stacked, delta=100,
                               protocol=AntiEntropyProtocol.PUSH,
                               fused_merge=fused, mailbox_slots=K, **kw)
        tsim = TGossipSimulator(th, tcore.Topology(adjacency), stacked,
                                delta=100, mailbox_slots=K, fused_merge=fused,
                                draws=JaxDraws(key, init_key=key),
                                device="cpu", **kw)
    return jsim, tsim


def to_port_state(tsim, jst):
    params = params_from_jax(jax.tree.map(np.asarray, jst.model.params),
                             tsim.handler.layout)
    opt = opt_state_from_jax(jax.tree.map(np.asarray, jst.model.opt_state),
                             tsim.handler.layout, tsim.handler.optimizer)
    n_up = torch.as_tensor(np.array(jst.model.n_updates))
    return tsim.init_state(TModelState(params, opt, n_up),
                           torch.as_tensor(np.array(jst.phase)))


def assert_params_close(tst, jst, layout, atol=1e-5, quantum=None):
    """Params within ``atol``, plus per element ``quantum(name, want)``
    where a quantized ring allows one encoding step."""
    got = params_to_numpy(tst.model.params, layout)
    want = {"Dense_0/" + k: np.asarray(v)
            for k, v in jst.model.params["Dense_0"].items()}
    for name in want:
        tol = atol if quantum is None else atol + quantum(name, want[name])
        assert (np.abs(got[name] - want[name]) <= tol).all(), \
            (name, float(np.abs(got[name] - want[name]).max()))
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
    """On CPU tensors every path takes the plain versions: no kernel
    launch is counted."""
    tops.reset_launch_counts()
    key = jax.random.PRNGKey(0)
    for fused in ("multi", "per_slot"):
        for history_dtype in ("float32", "int8"):
            _, tsim = make_pair(np.ones((N, N), dtype=bool), key,
                                fused=fused, history_dtype=history_dtype)
            st = tsim.init_nodes(common_init=True)
            st, rep = tsim.start(st, n_rounds=2)
            assert rep.sent_messages > 0
    assert sum(tops.LAUNCHES.values()) == 0


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
    {"mesh": "across processes"},
    {"cohort": 4, "chaos": {"outages": [{"nodes": [0], "start": 1,
                                         "stop": 2}], "horizon": 3},
     "raises": ValueError},
    {"cohort": {"size": 4}, "simulator": "PassThroughGossipSimulator",
     "raises": ValueError},
    {"topology": "nominal", "raises": ValueError},
])
def test_unported_options_raise(option):
    """A mesh across processes (the state placed across cards is not
    ported) raises; of cohort mode's options, ``chaos=``, a variant
    simulator and a NominalTopology without ``cohort=`` raise, as in the
    JAX engine."""
    from gossipy_tpu_torch import simulation as tsimulation
    option = dict(option)
    mode = option.pop("create_model_mode",
                      tcore.CreateModelMode.MERGE_UPDATE)
    raises = option.pop("raises", NotImplementedError)
    cls = getattr(tsimulation, option.pop("simulator", "GossipSimulator"))
    topo = tcore.Topology.clique(N)
    if option.pop("topology", None) == "nominal":
        topo = tsimulation.NominalTopology(N)
    if option.get("mesh") == "across processes":
        from gossipy_tpu_torch import parallel
        option["mesh"] = parallel.make_mesh(devices=[
            parallel.Position(torch.device("cpu"), rank, rank)
            for rank in (0, 1)])
    th = TSGDHandler(TLogReg(D_FEAT, 2), tlosses.cross_entropy,
                     input_shape=(D_FEAT,), create_model_mode=mode)
    with pytest.raises(raises):
        cls(th, topo, data(), mailbox_slots=K, device="cpu", **option)


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
        TModelState(params, (), torch.zeros(N, dtype=torch.int32)),
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


# -- the other deliver paths and the quantized rings -------------------------

def bf16_quantum(name, want):
    return 2.0 ** -8 * np.abs(want)


def int8_quantum(jst):
    """Half an int8 step of each leaf: 0.5 * the largest scale the ring
    has held for it (amax / 127), over cells and nodes."""
    def q(name, want):
        leaf = name.split("/")[1]
        return 0.5 * float(np.asarray(
            jst.history_scale["Dense_0"][leaf]).max())
    return q


# (name, topology, fused_merge, extra options, drop, online)
LEGS = [
    ("plain-wide", "clique", False, {"compact_deliver": False}, 0.0, 1.0),
    # cap 3: slot 0 (about 8 live receivers) takes the wide pass, the
    # higher slots the compacted one.
    ("plain-compact", "clique", False, {"compact_deliver": 3}, 0.2, 0.8),
    ("per_slot-float32", "clique", "per_slot", {}, 0.2, 0.8),
    ("per_slot-int8", "clique", "per_slot", {"history_dtype": "int8"},
     0.0, 1.0),
    ("multi-bfloat16", "clique", "multi", {"history_dtype": "bfloat16"},
     0.0, 1.0),
    ("multi-int8", "clique", "multi", {"history_dtype": "int8"}, 0.2, 0.8),
    # The hub's cell holds 2 live receivers a round: cap 4 compacts.
    ("multi-compact", "hub", "multi", {"compact_deliver": 4}, 0.0, 1.0),
]


@pytest.mark.parametrize("leg", LEGS, ids=[leg[0] for leg in LEGS])
def test_deliver_paths_match_jax_engine(leg):
    name, topology, fused, opts, drop, online = leg
    adjacency = (np.ones((N, N), dtype=bool) if topology == "clique"
                 else hub_adjacency(N))
    key = jax.random.PRNGKey(4)
    jsim, tsim = make_pair(adjacency, key, fused=fused, drop_prob=drop,
                           online_prob=online, **opts)
    assert tsim._compact_cap == jsim._compact_cap
    layout = tsim.handler.layout
    jst = jsim.init_nodes(key, common_init=True)
    tst = to_port_state(tsim, jst)
    jst, jrep = jsim.start(jst, n_rounds=ROUNDS, key=key, donate_state=False)
    tst, trep = tsim.start(tst, n_rounds=ROUNDS)

    for field in ("sent_per_round", "failed_per_round",
                  "compact_slots_per_round", "wide_slots_per_round",
                  "mailbox_hwm_per_round"):
        np.testing.assert_array_equal(getattr(trep, field),
                                      getattr(jrep, field), err_msg=field)
    for cause in ("drop", "offline", "overflow"):
        np.testing.assert_array_equal(trep.failed_per_cause[cause],
                                      jrep.failed_per_cause[cause])
    assert trep.total_size == jrep.total_size
    dtype = opts.get("history_dtype", "float32")
    quantum = {"float32": None, "bfloat16": bf16_quantum,
               "int8": int8_quantum(jst) if dtype == "int8" else None}[dtype]
    assert_params_close(tst, jst, layout, quantum=quantum)
    np.testing.assert_array_equal(tst.history_ages.numpy(),
                                  np.asarray(jst.history_ages))
    if dtype == "float32":
        tc, jc = trep.curves(False), jrep.curves(False)
        for m in jc:
            np.testing.assert_allclose(tc[m], jc[m], rtol=0, atol=1e-6,
                                       err_msg=m)
    # Every leg exercises what it is there for.
    compact = int(trep.compact_slots_per_round.sum())
    wide = int(trep.wide_slots_per_round.sum())
    if "compact" in name:
        assert compact > 0
    else:
        assert compact == 0 and wide > 0
    if name == "plain-compact":
        assert wide > 0
    if fused != "multi":  # the slot loop drains more than one slot a round
        assert (trep.wide_slots_per_round + trep.compact_slots_per_round
                > 1).any()


def port_run(fused, compact, adjacency, seed=1, rounds=ROUNDS, **kw):
    _, tsim = make_pair(adjacency, jax.random.PRNGKey(0), fused=fused,
                        compact_deliver=compact, **kw)
    tsim.draws = TorchDraws(seed)
    st = tsim.init_nodes(torch.Generator().manual_seed(seed))
    return tsim.start(st, n_rounds=rounds)


@pytest.mark.parametrize("fused,cap,topology", [
    (False, 2, "clique"), (False, 5, "clique"), ("multi", 4, "hub"),
    ("multi", 6, "clique")])
def test_compaction_on_equals_off(fused, cap, topology):
    """As tests/test_compact_deliver.py holds it in the reference: the same
    run with compaction off and on (any capacity, overflow falling back to
    the wide pass) gives the same trajectory."""
    adjacency = (np.ones((N, N), dtype=bool) if topology == "clique"
                 else hub_adjacency(N))
    # Seed 6: every case has a round whose live receivers fit the
    # capacity under the default provider's draws.
    s_off, r_off = port_run(fused, False, adjacency, seed=6, drop_prob=0.1)
    s_on, r_on = port_run(fused, cap, adjacency, seed=6, drop_prob=0.1)
    assert int(r_on.compact_slots_per_round.sum()) > 0
    assert int(r_off.compact_slots_per_round.sum()) == 0
    np.testing.assert_allclose(s_on.model.params.numpy(),
                               s_off.model.params.numpy(), rtol=0, atol=1e-6)
    assert torch.equal(s_on.model.n_updates, s_off.model.n_updates)
    np.testing.assert_array_equal(r_on.sent_per_round, r_off.sent_per_round)
    np.testing.assert_array_equal(r_on.failed_per_round,
                                  r_off.failed_per_round)
    np.testing.assert_array_equal(
        r_on.compact_slots_per_round + r_on.wide_slots_per_round,
        r_off.wide_slots_per_round)
    np.testing.assert_allclose(r_on.curves(False)["accuracy"],
                               r_off.curves(False)["accuracy"], atol=1e-6)


def big_data(n):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(4 * n, D_FEAT)).astype(np.float32)
    y = rng.integers(0, 2, 4 * n)
    return DataDispatcher(ClassificationDataHandler(X, y, test_size=0.25,
                                                    seed=1), n=n).stacked()


@pytest.mark.parametrize("fused,compact", [
    (False, None), ("multi", None), ("per_slot", None), (False, True),
    ("multi", True), (False, 7), (False, 100), (False, False)])
def test_compaction_rules_match_jax(fused, compact):
    """The capacity the constructor settles on, at 64 nodes and K = 4
    (auto: on for the plain path only), as in the JAX engine."""
    n = 64
    stacked = big_data(n)
    jh = SGDHandler(model=LogisticRegression(D_FEAT, 2),
                    loss=losses.cross_entropy, optimizer=optax.sgd(0.1),
                    n_classes=2, input_shape=(D_FEAT,))
    th = TSGDHandler(TLogReg(D_FEAT, 2), tlosses.cross_entropy, n_classes=2,
                     input_shape=(D_FEAT,))
    jsim = GossipSimulator(jh, Topology.clique(n), stacked, mailbox_slots=K,
                           fused_merge=fused, compact_deliver=compact)
    tsim = TGossipSimulator(th, tcore.Topology.clique(n), stacked,
                            mailbox_slots=K, fused_merge=fused,
                            compact_deliver=compact, device="cpu")
    assert tsim._compact_cap == jsim._compact_cap
    np.testing.assert_allclose(tsim._lam_vector(), jsim._lam_vector())
    if fused is False and compact is None:
        assert tsim._compact_cap == 32


def test_compaction_misuse_rejected():
    th = TSGDHandler(TLogReg(D_FEAT, 2), tlosses.cross_entropy,
                     input_shape=(D_FEAT,))
    topo = tcore.Topology.clique(N)
    with pytest.raises(ValueError, match="per-slot"):
        TGossipSimulator(th, topo, data(), mailbox_slots=K,
                         fused_merge="per_slot", compact_deliver=True,
                         device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        TGossipSimulator(th, topo, data(), mailbox_slots=K,
                         fused_merge=False, compact_deliver=-2, device="cpu")
    with pytest.warns(UserWarning, match="no effect"):
        sim = TGossipSimulator(th, topo, data(), mailbox_slots=1,
                               fused_merge=False, compact_deliver=True,
                               device="cpu")
    assert sim._compact_cap is None
    sim = TGossipSimulator(th, topo, data(), mailbox_slots=K,
                           fused_merge=False, compact_deliver=100,
                           device="cpu")
    assert sim._compact_cap == N


@pytest.mark.parametrize("mode", [CreateModelMode.UPDATE,
                                  CreateModelMode.PASS,
                                  CreateModelMode.UPDATE_MERGE])
def test_plain_path_other_modes_match_jax_engine(mode):
    """The plain path runs the handler's ``call``: UPDATE, PASS and
    UPDATE_MERGE (two models trained a receive, under both halves of each
    node's stream) too."""
    key = jax.random.PRNGKey(6)
    adjacency = np.ones((N, N), dtype=bool)
    jsim, tsim = make_pair(adjacency, key, fused=False, compact_deliver=3)
    jsim.handler.mode = mode
    tsim.handler.mode = mode
    jst = jsim.init_nodes(key, common_init=False)
    tst = to_port_state(tsim, jst)
    jst, jrep = jsim.start(jst, n_rounds=2, key=key, donate_state=False)
    tst, trep = tsim.start(tst, n_rounds=2)
    np.testing.assert_array_equal(trep.compact_slots_per_round,
                                  jrep.compact_slots_per_round)
    assert_params_close(tst, jst, tsim.handler.layout)


def test_mode_and_path_rules():
    th = TSGDHandler(TLogReg(D_FEAT, 2), tlosses.cross_entropy,
                     input_shape=(D_FEAT,),
                     create_model_mode=CreateModelMode.UPDATE)
    topo = tcore.Topology.clique(N)
    for fused in ("multi", "per_slot"):  # the kernels fuse MERGE_UPDATE only
        with pytest.raises(ValueError, match="MERGE_UPDATE"):
            TGossipSimulator(th, topo, data(), mailbox_slots=K,
                             fused_merge=fused, device="cpu")
    # UPDATE_MERGE trains two models a receive: the plain path only.
    th.mode = CreateModelMode.UPDATE_MERGE
    for fused in ("multi", "per_slot"):
        with pytest.raises(ValueError, match="MERGE_UPDATE"):
            TGossipSimulator(th, topo, data(), mailbox_slots=K,
                             fused_merge=fused, device="cpu")
    TGossipSimulator(th, topo, data(), mailbox_slots=K, fused_merge=False,
                     device="cpu")
    th.mode = CreateModelMode.MERGE_UPDATE
    with pytest.raises(ValueError, match="fused_merge"):
        TGossipSimulator(th, topo, data(), mailbox_slots=K,
                         fused_merge="both", device="cpu")
    sim = TGossipSimulator(th, topo, data(), mailbox_slots=K,
                           fused_merge=True, device="cpu")
    assert sim.fused_merge == "multi"


# (name, fused_merge, compact_deliver, rule)
OPT_LEGS = [
    ("plain-compact-momentum", False, 3, "momentum"),
    ("plain-wide-adam", False, False, "adam"),
    ("per_slot-momentum", "per_slot", None, "momentum"),
    ("multi-adam", "multi", None, "adam"),
    ("multi-compact-momentum", "multi", 4, "momentum"),
]
OPT_RULES = {"momentum": lambda: (optax.sgd(0.1, momentum=0.9),
                                  toptim.sgd(0.1, momentum=0.9)),
             "adam": lambda: (optax.adam(0.05), toptim.adam(0.05))}


@pytest.mark.parametrize("leg", OPT_LEGS, ids=[leg[0] for leg in OPT_LEGS])
def test_optimizer_state_flows_through_the_engine(leg):
    """A handler with optimizer state on every deliver path, wide and
    compact: ``init_nodes`` gives each node the rule's initial state, the
    receiver trains with (and the fused paths keep) its own state, and
    the state survives the compacted gather and scatter. Params and every
    state tensor within 1e-5 of the JAX engine's; ages and adam's counts
    exactly."""
    name, fused, compact, rule = leg
    adjacency = (hub_adjacency(N) if "multi-compact" in name
                 else np.ones((N, N), dtype=bool))
    key = jax.random.PRNGKey(8)
    jsim, tsim = make_pair(adjacency, key, fused=fused,
                           compact_deliver=compact, rules=OPT_RULES[rule](),
                           drop_prob=0.2)
    jst = jsim.init_nodes(key, common_init=True)
    tst = to_port_state(tsim, jst)
    own = tsim.init_nodes(common_init=True)
    assert len(own.model.opt_state) == len(tst.model.opt_state) > 0
    jst, jrep = jsim.start(jst, n_rounds=3, key=key, donate_state=False)
    tst, trep = tsim.start(tst, n_rounds=3)
    np.testing.assert_array_equal(trep.compact_slots_per_round,
                                  jrep.compact_slots_per_round)
    np.testing.assert_array_equal(trep.sent_per_round, jrep.sent_per_round)
    if compact:
        assert trep.compact_slots_per_round.sum() > 0
    assert_params_close(tst, jst, tsim.handler.layout)
    want = opt_state_from_jax(jax.tree.map(np.asarray, jst.model.opt_state),
                              tsim.handler.layout, tsim.handler.optimizer)
    for got, w in zip(tst.model.opt_state, want):
        if got.dtype == torch.int32:
            np.testing.assert_array_equal(got.numpy(), w.numpy())
        else:
            np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0,
                                       atol=1e-5)


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("rule", ["sgd", "adam"])
def test_memory_budget_matches_jax_terms(wire, rule):
    """The JAX engine's keys; the terms the two layouts share are equal
    (depth, ages, mailbox, reply box, int8 sidecar, aux); the port's
    params, optimizer and ring terms count the ``stride``-wide row where
    JAX counts the model's width; the data term counts the port's int64
    labels."""
    rules = None if rule == "sgd" else (optax.adam(0.1), toptim.adam(0.1))
    jsim, tsim = make_pair(np.ones((N, N), dtype=bool), jax.random.PRNGKey(0),
                           rules=rules, history_dtype=wire,
                           sampling_eval=0.5)
    jb, tb = jsim.memory_budget(), tsim.memory_budget()
    assert set(tb) == set(jb)
    for k in ("history_depth", "history_ages_bytes", "mailbox_bytes",
              "reply_box_bytes", "history_ring_sidecar", "history_dtype",
              "aux_bytes", "eval_peak_bytes"):
        assert tb[k] == jb[k], k
    layout = tsim.handler.layout
    n_rows = {"sgd": 1, "adam": 3}[rule]
    per_node = 4 * n_rows * layout.stride + 4 + (4 if rule == "adam" else 0)
    assert tb["model_and_opt_bytes"] == N * per_node
    assert jb["model_and_opt_bytes"] == N * (per_node - 4 * n_rows
                                             * (layout.stride - layout.width))
    item = {"float32": 4, "bfloat16": 2, "int8": 1}[wire]
    D = tb["history_depth"]
    assert tb["history_ring_bytes"] - tb["history_ring_sidecar"] == \
        D * N * layout.stride * item
    assert tb["data_bytes"] == sum(t.numel() * t.element_size()
                                   for t in tsim.data.values())
    assert tb["total_bytes"] == sum(v for k, v in tb.items()
                                    if k.endswith("_bytes")
                                    and k != "total_bytes")
