"""The port's checkpoints, held against the JAX package's
``tests/test_checkpoint.py`` and its resumed runs.

- A state saved and restored is the same state, leaf for leaf, with its
  draw state; a run of ``a + b`` rounds equals ``a`` rounds, a save, a
  FRESH simulator's load and ``b`` more, bit for bit on the CPU, under the
  port's stream draws (``TorchDraws``: the generator's state rides in the
  checkpoint), on every deliver path and ring format, with a variant's
  ``aux`` (token balances), and through ``CheckpointManager`` (periodic,
  retention, resume from the latest).
- Under the JAX draw oracle (keyed on the round, no draw state), a
  resumed port run equals a resumed JAX run (orbax checkpoint) as
  ``torch_pairs.assert_same_run`` holds two runs.
- The sequential engine's ``SeqState`` through the manager gives the
  message stream of the same chunks run without it.
- A template of another configuration (``mailbox_slots``,
  ``history_dtype``) is refused with ``ValueError`` naming the leaf; the
  ``meta`` sidecar; ``slice_lane``; ``check_memory_budget``; every
  ``torch.load`` of the port passes ``weights_only=True``.
"""

import ast
import dataclasses
import os
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from gossipy_tpu import checkpoint as jckpt
from gossipy_tpu_torch import core as tcore
from gossipy_tpu_torch.checkpoint import CheckpointManager, clone_state, \
    flatten_state, load_checkpoint_meta, restore_checkpoint, \
    save_checkpoint, slice_lane
from gossipy_tpu_torch.core import AntiEntropyProtocol, CreateModelMode
from gossipy_tpu_torch.flow_control import SimpleTokenAccount
from gossipy_tpu_torch.handlers import PegasosHandler
from gossipy_tpu_torch.models import AdaLine
from gossipy_tpu_torch.random import DrawProvider, TorchDraws
from gossipy_tpu_torch.simulation import GossipSimulator, \
    SequentialGossipSimulator, TokenizedGossipSimulator
from gossipy_tpu_torch.simulation.engine import MemoryBudgetExceeded
from torch_oracle import JaxDraws
from torch_pairs import assert_same_run, clique_pair, handlers, \
    message_logs, small_data, to_port_state

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(1)


def pegasos_sim(n=8, draws_seed=5, **kw):
    """The JAX test's configuration: Pegasos over AdaLine, UPDATE, a
    clique, PUSH, ``delta=10``."""
    data = small_data(signed=True, n=n)
    handler = PegasosHandler(AdaLine(10), 0.01,
                             create_model_mode=CreateModelMode.UPDATE)
    return GossipSimulator(handler, tcore.Topology.clique(n), data,
                           delta=10, protocol=AntiEntropyProtocol.PUSH,
                           draws=TorchDraws(draws_seed), device="cpu", **kw)


def logreg_sim(cls=GossipSimulator, draws_seed=5, **kw):
    """LogReg under SGD 0.1 on 12 nodes of ``random_regular(12, 4)``."""
    _, th = handlers(10, 8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return cls(th, tcore.Topology.random_regular(12, 4, seed=5),
                   small_data(), delta=100, draws=TorchDraws(draws_seed),
                   device="cpu", **kw)


def assert_states_equal(a, b):
    fa, fb = flatten_state(a), flatten_state(b)
    assert sorted(fa) == sorted(fb)
    for k, v in fa.items():
        w = fb[k]
        if isinstance(v, torch.Tensor):
            assert v.dtype == w.dtype and torch.equal(v, w), k
        elif isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, w, err_msg=k)
        else:
            assert v == w, k


def assert_same_reports(a, b):
    for field in ("sent_per_round", "failed_per_round",
                  "mailbox_hwm_per_round", "compact_slots_per_round",
                  "wide_slots_per_round"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                      err_msg=field)
    for cause, v in a.failed_per_cause.items():
        np.testing.assert_array_equal(v, b.failed_per_cause[cause])
    assert a.total_size == b.total_size


def test_roundtrip(tmp_path):
    sim = pegasos_sim()
    st = sim.init_nodes(torch.Generator().manual_seed(1))
    st, _ = sim.start(st, n_rounds=3)
    path = save_checkpoint(str(tmp_path / "ckpt"), st, draws=sim.draws)
    want = sim.draws.get_state()["generator"]

    other = pegasos_sim(draws_seed=9)
    template = other.init_nodes(torch.Generator().manual_seed(7))
    restored, draws = restore_checkpoint(path, template, other.draws)
    assert_states_equal(st, restored)
    assert draws is other.draws
    assert torch.equal(draws.get_state()["generator"], want)
    assert restored.round == 3


@pytest.mark.parametrize("fused,wire", [
    ("multi", "float32"), ("multi", "bfloat16"), ("multi", "int8"),
    ("per_slot", "float32"), (False, "float32")])
def test_resume_continues_identically(tmp_path, fused, wire):
    """3 rounds, ``save``, a fresh simulator's ``load`` and 4 more ==
    7 straight rounds, bit for bit, with equal accounting: every deliver
    path (the kernels' plain versions here) and ring format (the bf16 ring
    and the int8 ring with its scales checkpointed in their wire form)."""
    kw = dict(fused_merge=fused, history_dtype=wire)
    a = logreg_sim(**kw)
    full = a.init_nodes(torch.Generator().manual_seed(1))
    full, rep_full = a.start(full, n_rounds=7)

    b = logreg_sim(**kw)
    part = b.init_nodes(torch.Generator().manual_seed(1))
    part, rep_a = b.start(part, n_rounds=3)
    path = b.save(str(tmp_path / "ckpt"), part)
    if wire != "float32":
        assert part.history_params.dtype == b._HISTORY_DTYPES[wire]
    c = logreg_sim(draws_seed=11, **kw)   # another seed: the load sets it
    resumed, draws = c.load(path)
    assert draws is c.draws
    resumed, rep_b = c.start(resumed, n_rounds=4)
    assert_states_equal(full, resumed)
    from gossipy_tpu_torch.simulation.report import SimulationReport
    assert_same_reports(rep_full, SimulationReport.concatenate([rep_a,
                                                                rep_b]))


def test_tokenized_aux_roundtrips(tmp_path):
    """A variant's ``aux`` (the token balances) rides in the checkpoint:
    the resumed token run equals the straight one."""
    kw = dict(token_account=SimpleTokenAccount(C=2), fused_merge="per_slot")
    a = logreg_sim(TokenizedGossipSimulator, **kw)
    full = a.init_nodes(torch.Generator().manual_seed(2))
    full, _ = a.start(full, n_rounds=6)
    b = logreg_sim(TokenizedGossipSimulator, **kw)
    part = b.init_nodes(torch.Generator().manual_seed(2))
    part, _ = b.start(part, n_rounds=2)
    assert "balance" in part.aux
    path = b.save(str(tmp_path / "ckpt"), part)
    c = logreg_sim(TokenizedGossipSimulator, draws_seed=0, **kw)
    resumed, _ = c.load(path)
    resumed, _ = c.start(resumed, n_rounds=4)
    assert_states_equal(full, resumed)


def test_resumed_port_run_matches_resumed_jax_run(tmp_path, key):
    """Under the oracle: the JAX run of 3 rounds, an orbax checkpoint and
    3 more against the port's 3 rounds, ``save``, a fresh simulator's
    ``load`` (no draw state: the oracle is keyed on the round) and 3
    more."""
    jsim, tsim = clique_pair(key, fused_merge="multi")
    jst = jsim.init_nodes(key, common_init=True)
    tst = to_port_state(tsim, jst)
    jst, _ = jsim.start(jst, n_rounds=3, key=key, donate_state=False)
    tst, _ = tsim.start(tst, n_rounds=3)
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax"), jst, key=key)
    tpath = tsim.save(str(tmp_path / "port"), tst)
    jst, jkey = jckpt.restore_checkpoint(jpath, jsim.init_nodes(key), key)
    _, tsim2 = clique_pair(key, fused_merge="multi")
    tst, draws = tsim2.load(tpath)
    assert draws is None   # the oracle keeps no draw state
    jst, jrep = jsim.start(jst, n_rounds=3, key=jkey, donate_state=False)
    tst, trep = tsim2.start(tst, n_rounds=3)
    assert tst.round == int(np.asarray(jst.round)) == 6
    assert_same_run(jsim, tsim2, jst, tst, jrep, trep)


def test_periodic_and_retention(tmp_path):
    sim = pegasos_sim()
    st = sim.init_nodes(torch.Generator().manual_seed(1))
    before = clone_state(st)
    mgr = CheckpointManager(str(tmp_path / "run"), interval=2, max_to_keep=2)
    reports = []
    final = mgr.run(sim, st, until_round=6, reports=reports)
    assert final.round == 6
    assert mgr.checkpoints() == [4, 6]   # retention pruned round 2
    assert sum(len(r.get_evaluation(local=True)) for r in reports) == 6
    assert_states_equal(st, before)      # the caller's state is untouched


def test_resume_from_latest(tmp_path):
    """A fresh manager and a fresh simulator on the same directory resume
    from round 4, and the run equals the straight 8 rounds."""
    sim = pegasos_sim()
    st = sim.init_nodes(torch.Generator().manual_seed(1))
    mgr = CheckpointManager(str(tmp_path / "run"), interval=2, max_to_keep=3)
    mgr.run(sim, st, until_round=4)
    assert mgr.latest() == 4

    sim2 = pegasos_sim(draws_seed=99)
    mgr2 = CheckpointManager(str(tmp_path / "run"), interval=2, max_to_keep=3)
    final = mgr2.run(sim2, sim2.init_nodes(torch.Generator().manual_seed(9)),
                     until_round=8)
    assert final.round == 8

    ref = pegasos_sim()
    straight = ref.init_nodes(torch.Generator().manual_seed(1))
    straight, _ = ref.start(straight, n_rounds=8)
    assert_states_equal(straight, final)


def test_restore_without_template_draws(tmp_path):
    """A saved ``TorchDraws`` state comes back in a new provider; a
    checkpoint saved without draws restores with ``draws`` None."""
    sim = pegasos_sim()
    st = sim.init_nodes(torch.Generator().manual_seed(1))
    path = save_checkpoint(str(tmp_path / "ck"), st, draws=sim.draws)
    want = sim.draws.get_state()["generator"]
    restored, draws = restore_checkpoint(path, sim.init_nodes())
    assert_states_equal(st, restored)
    assert isinstance(draws, TorchDraws) and draws is not sim.draws
    assert torch.equal(draws.get_state()["generator"], want)
    path = save_checkpoint(str(tmp_path / "ck2"), st)
    restored, draws = restore_checkpoint(path, sim.init_nodes())
    assert_states_equal(st, restored)
    assert draws is None
    with pytest.raises(FileExistsError):
        save_checkpoint(str(tmp_path / "ck2"), st, force=False)


def test_stream_draws_refuse_a_drawless_checkpoint(tmp_path):
    """A checkpoint saved without draws cannot resume a ``TorchDraws``
    run: restoring it into one raises rather than leaving the provider at
    its fresh stream. A provider keyed on the round (no state) takes it."""
    sim = pegasos_sim()
    st = sim.init_nodes(torch.Generator().manual_seed(1))
    path = save_checkpoint(str(tmp_path / "ck"), st)
    template = sim.init_nodes()
    before = sim.draws.get_state()["generator"]
    with pytest.raises(ValueError, match="keeps no draw state"):
        restore_checkpoint(path, template, sim.draws)
    assert torch.equal(sim.draws.get_state()["generator"], before)
    with pytest.raises(ValueError, match="keeps no draw state"):
        sim.load(path)
    restored, draws = restore_checkpoint(path, sim.init_nodes(),
                                         DrawProvider())
    assert_states_equal(st, restored)
    assert draws is None


@pytest.mark.parametrize("change,leaf", [
    ({"mailbox_slots": 3}, "mailbox.sender"),
    ({"history_dtype": "bfloat16"}, "history_params"),
    ({"history_dtype": "int8"}, "history_params"),
])
def test_refused_template(tmp_path, change, leaf):
    """A template of another configuration is refused, naming the leaf:
    another ``mailbox_slots`` (the ``[D, N, K]`` mailbox), another
    ``history_dtype`` (the ring's wire dtype)."""
    sim = logreg_sim(mailbox_slots=4)
    st = sim.init_nodes(torch.Generator().manual_seed(1))
    path = sim.save(str(tmp_path / "ck"), st)
    other = logreg_sim(**{"mailbox_slots": 4, **change})
    with pytest.raises(ValueError, match=leaf.replace(".", r"\.")):
        other.load(path)


def test_sequential_through_manager(tmp_path):
    """``SeqState`` (a stacked ``ModelState``, numpy phases and balances,
    an int round) through ``CheckpointManager`` (interval 3, 2 kept): run
    to round 6, then a fresh simulator and manager resume from the latest
    to round 9; the message stream, accounting and params equal the same
    three 3-round chunks run without checkpoints. A sequential ``start``
    begins with empty queues (as in the JAX engine), so the reference is
    the same chunks, not one 9-round call."""
    def build(seed):
        jh, th = handlers(10, 8)
        sim = SequentialGossipSimulator(
            th, tcore.Topology.random_regular(12, 4, seed=5), small_data(),
            delta=20, drop_prob=0.1, online_prob=0.9,
            token_account=SimpleTokenAccount(C=2), draws=TorchDraws(seed),
            device="cpu")
        log = message_logs()[1]
        sim.add_receiver(log)
        return sim, log

    ref, ref_log = build(3)
    st = ref.init_nodes(torch.Generator().manual_seed(4))
    for _ in range(3):
        st, _ = ref.start(st, n_rounds=3)

    a, a_log = build(3)
    st0 = a.init_nodes(torch.Generator().manual_seed(4))
    mgr = CheckpointManager(str(tmp_path / "seq"), interval=3, max_to_keep=2)
    mgr.run(a, st0, until_round=6)
    assert mgr.checkpoints() == [3, 6]
    b, b_log = build(77)
    mgr2 = CheckpointManager(str(tmp_path / "seq"), interval=3,
                             max_to_keep=2)
    final = mgr2.run(b, b.init_nodes(local_train=False), until_round=9)
    assert mgr2.checkpoints() == [6, 9]
    assert final.round == 9
    assert a_log.events + b_log.events == ref_log.events
    assert a_log.rounds + b_log.rounds == ref_log.rounds
    assert_states_equal(st, final)


def test_meta_sidecar(tmp_path):
    sim = pegasos_sim()
    st = sim.init_nodes()
    path = save_checkpoint(str(tmp_path / "ck"), st,
                           meta={"round": 0, "why": "test"})
    assert load_checkpoint_meta(path) == {"round": 0, "why": "test"}
    assert os.path.exists(path + ".meta.json")
    assert load_checkpoint_meta(save_checkpoint(str(tmp_path / "bare"),
                                                st)) is None


def test_slice_lane():
    """``slice_lane`` takes lane ``i`` of a batched state as host numpy
    (0-d leaves and Python scalars pass through), and entry ``i`` of
    ``run_repetitions``' list of states; the lane checkpoints and
    restores into a solo template."""
    batched = {"a": torch.arange(12).reshape(3, 4), "b": np.ones((3, 2)),
               "s": torch.tensor(5), "r": 7}
    lane = slice_lane(batched, 1)
    np.testing.assert_array_equal(lane["a"], [4, 5, 6, 7])
    assert lane["b"].shape == (2,) and int(lane["s"]) == 5 and lane["r"] == 7
    sim = pegasos_sim()
    states, _ = sim.run_repetitions(2, [1, 2])
    one = slice_lane(states, 1)
    assert isinstance(one.model.params, np.ndarray)
    np.testing.assert_array_equal(one.model.params,
                                  states[1].model.params.numpy())


def test_check_memory_budget(monkeypatch):
    """An explicit limit one byte below the budget raises
    ``MemoryBudgetExceeded`` naming the dominant term; the variable sets
    the limit when no argument does; on the CPU without either the check
    passes."""
    sim = logreg_sim()
    monkeypatch.delenv("GOSSIPY_TPU_MEMORY_LIMIT", raising=False)
    budget = sim.check_memory_budget()
    assert budget == sim.memory_budget()
    total = budget["total_bytes"]
    assert sim.check_memory_budget(limit_bytes=total) == budget
    with pytest.raises(MemoryBudgetExceeded) as info:
        sim.check_memory_budget(limit_bytes=total - 1)
    err = info.value
    assert err.predicted_bytes == total and err.limit_bytes == total - 1
    terms = {k: v for k, v in budget.items()
             if k.endswith("_bytes") and k != "total_bytes"}
    assert err.dominant_term == max(terms, key=terms.get)
    monkeypatch.setenv("GOSSIPY_TPU_MEMORY_LIMIT", str(total - 1))
    with pytest.raises(MemoryBudgetExceeded):
        sim.check_memory_budget()
    assert sim.check_memory_budget(limit_bytes=total) == budget


def test_torch_load_only_with_weights_only():
    """Every ``torch.load`` call in the port passes ``weights_only=True``."""
    calls = 0
    for path in sorted((REPO / "gossipy_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and isinstance(node.func,
                                                         ast.Attribute) \
                    and node.func.attr == "load" \
                    and getattr(node.func.value, "id", None) == "torch":
                calls += 1
                kw = {k.arg: k.value for k in node.keywords}
                assert isinstance(kw.get("weights_only"), ast.Constant) \
                    and kw["weights_only"].value is True, path
    assert calls >= 1


def test_draw_state_of_keyed_provider(key):
    """A provider keyed on the round keeps no state."""
    assert JaxDraws(key).get_state() is None
    with pytest.raises(ValueError):
        JaxDraws(key).set_state({"generator": None})
    d = TorchDraws(3)
    s = d.get_state()
    a = torch.rand(4, generator=d.generator)
    d.set_state(s)
    assert torch.equal(a, torch.rand(4, generator=d.generator))


def test_clone_state_shares_nothing():
    sim = logreg_sim(history_dtype="int8")
    st = sim.init_nodes()
    cp = clone_state(st)
    assert_states_equal(st, cp)
    for k, v in flatten_state(st).items():
        if isinstance(v, torch.Tensor) and v.numel():
            assert v.data_ptr() != flatten_state(cp)[k].data_ptr(), k
    assert dataclasses.is_dataclass(cp) and cp is not st
