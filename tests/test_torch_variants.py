"""The node-behaviour simulators (``gossipy_tpu/simulation/nodes.py``)
against the JAX package's, from the same state under the JAX draw oracle.

Each variant is built in both engines on the same arrays (12 nodes on a
Barabasi-Albert, regular or complete graph) and run once in the JAX
engine; the port runs it on every deliver path it admits, each held
against that run (``torch_pairs.check_variant``): the plain path wide
and compact (an explicit capacity of 4, the automatic one needing N >=
48). Accounting (the compact and wide slot counts by their sum where the
port's path is not the JAX run's), mailbox with its ``extra`` payloads,
reply box, ages, the ring's ages and the variant's ``aux`` exactly;
params and the float ``aux`` within 1e-5 (Pegasos's within 1e-5 plus
1e-6 of the value; an int8 ring adds one encoding step, as
``torch_pairs`` sets out). Then the admission rules: a fused path is
refused for each variant that overrides a hook it replaces, the default
falls back to the plain path, compaction is refused to a variant whose
receive reads full-width state or that does not declare itself safe, and
``memory_budget`` counts ``aux`` and the partition ages.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

from gossipy_tpu.core import CreateModelMode
from gossipy_tpu.data import ClassificationDataHandler, DataDispatcher
from gossipy_tpu_torch import core as tcore
from gossipy_tpu_torch import flow_control as tflow
from gossipy_tpu_torch import simulation as tsimulation
from torch_pairs import D_FEAT, N, PEGASOS_RTOL, check_variant, logreg, \
    make, pegasos, small_data, to_port_state, topology

torch.set_num_threads(1)

PATHS = {"plain": dict(fused_merge=False, compact_deliver=False),
         "plain-compact": dict(fused_merge=False, compact_deliver=4)}


def passthrough(key, **kw):
    kw = {"fused_merge": False, "compact_deliver": 4, **kw}
    return make("PassThroughGossipSimulator", pegasos(), topology("ba"),
                small_data(signed=True), key, sync=False,
                delay=tcore.UniformDelay(0, 150), **kw)


def cacheneigh(wire):
    def build(key, **kw):
        return make("CacheNeighGossipSimulator", pegasos(), topology("ba"),
                    small_data(signed=True), key, sync=False,
                    history_dtype=wire, **kw)
    return build


CACHENEIGH = {w: cacheneigh(w) for w in ("float32", "int8")}


def subset(kind):
    name = ("SamplingGossipSimulator" if kind == "sampling"
            else "PartitioningGossipSimulator")

    def build(key, **kw):
        kw = {"fused_merge": False, "compact_deliver": 4, **kw}
        return make(name, logreg(kind, CreateModelMode.UPDATE),
                    topology("regular"), small_data(), key,
                    delay=tcore.UniformDelay(0, 10), sync=True, **kw)
    return build


SUBSET = {k: subset(k) for k in ("sampling", "partitioned")}


def pens(key, step1_rounds=3, **kw):
    return make("PENSGossipSimulator", logreg(), topology("clique"),
                small_data(), key, sync=False, n_sampled=3, m_top=2,
                step1_rounds=step1_rounds, **kw)


# -- Giaretta 2019's node behaviours -----------------------------------------

@pytest.mark.parametrize("path", sorted(PATHS))
def test_passthrough_matches_jax(path):
    tsim, tst, trep = check_variant(passthrough, 21, 6, common_init=False,
                                    rtol=PEGASOS_RTOL, **PATHS[path])
    assert tsim._compact_cap == (4 if path == "plain-compact" else None)
    # The payload of the messages still in flight is the sender's degree.
    snd, ext = tst.mailbox.sender, tst.mailbox.extra
    live = snd >= 0
    deg = torch.as_tensor(tsim.topology.degrees)
    assert live.any()
    assert torch.equal(ext[live], deg[snd[live].long()].to(ext.dtype))
    if path == "plain-compact":
        assert trep.compact_slots_per_round.sum() > 0


@pytest.mark.parametrize("wire", sorted(CACHENEIGH))
def test_cacheneigh_matches_jax(wire):
    tsim, tst, _ = check_variant(CACHENEIGH[wire], 22, 6, common_init=False,
                                 rtol=PEGASOS_RTOL)
    assert tsim.fused_merge is False and tsim._compact_cap is None
    assert tst.aux["cache_valid"].any()
    assert tst.aux["cache_params"].dtype == tsim._HISTORY_DTYPES[wire]


# -- Hegedus 2021's subset merges ----------------------------------------------

@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("kind", sorted(SUBSET))
def test_subset_merge_matches_jax(kind, path):
    tsim, tst, trep = check_variant(SUBSET[kind], 23, 6, **PATHS[path])
    if kind == "partitioned":
        assert tst.model.n_updates.shape == (N, 3)
        assert tst.history_ages.shape[1:] == (N, 3)
        ext = tst.mailbox.extra[tst.mailbox.sender >= 0]
        assert 0 <= int(ext.min()) and int(ext.max()) < 3
    if path == "plain-compact":
        assert trep.compact_slots_per_round.sum() > 0


# -- Onoszko 2021's PENS --------------------------------------------------------

def test_pens_matches_jax_across_the_phase_switch():
    tsim, tst, trep = check_variant(pens, 24, 7)
    assert tsim.fused_merge is False and tsim._compact_cap is None
    assert tst.aux["best"].any() and tst.aux["neigh_counter"].sum() > 0
    assert len(trep.sent_per_round) == 7


def test_pens_run_repetitions_runs_both_phases():
    _, tsim = pens(jax.random.PRNGKey(0), step1_rounds=2)
    states, reports = tsim.run_repetitions(4, [1, 2])
    assert [len(r.sent_per_round) for r in reports] == [4, 4]
    assert all(s.round == 4 and s.aux["best"].any() for s in states)
    with pytest.raises(ValueError, match="MERGE_UPDATE"):
        tsimulation.PENSGossipSimulator(
            logreg(mode=CreateModelMode.UPDATE_MERGE)[1], topology("clique"),
            small_data(), device="cpu")


# -- admission ------------------------------------------------------------------------

# The fused paths each variant is refused: both where it overrides a
# receive hook; "multi" alone where it overrides a per-slot hook.
REFUSED = {"PassThroughGossipSimulator": ("multi", "per_slot"),
           "CacheNeighGossipSimulator": ("multi", "per_slot"),
           "PENSGossipSimulator": ("multi", "per_slot"),
           "SamplingGossipSimulator": ("multi", "per_slot"),
           "TokenizedGossipSimulator": ("multi",)}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_fused_admission_follows_the_hooks(name):
    kw = ({"token_account": tflow.SimpleTokenAccount(C=1)}
          if name.startswith("Tokenized") else {})
    handler = logreg()[1] if name == "PENSGossipSimulator" else pegasos()[1]
    cls = getattr(tsimulation, name)
    data = small_data(signed=True)

    def build(**extra):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return cls(handler, topology("ba"), data, device="cpu", **kw,
                       **extra)
    for mode in ("multi", "per_slot"):
        if mode in REFUSED[name]:
            with pytest.raises(ValueError, match="overridden"):
                build(fused_merge=mode)
        else:
            assert build(fused_merge=mode).fused_merge == mode
    # The handler admits the fused path; the variant's default is plain.
    assert build().fused_merge is False
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert tsimulation.GossipSimulator(
            handler, topology("ba"), data,
            device="cpu").fused_merge == "multi"


def test_compaction_admission_follows_the_hooks():
    handler = pegasos()[1]
    data = small_data(signed=True)
    with pytest.raises(ValueError, match="_apply_receive"):
        tsimulation.CacheNeighGossipSimulator(handler, topology("ba"), data,
                                              device="cpu",
                                              compact_deliver=4)

    class Undeclared(tsimulation.PassThroughGossipSimulator):
        _compact_safe = False
    with pytest.raises(ValueError, match="_compact_safe"):
        Undeclared(handler, topology("ba"), data, device="cpu",
                   compact_deliver=4)
    # At N >= 48 the automatic compaction stays off for an undeclared
    # override and on for a declared one.
    big = tcore.Topology.random_regular(48, 4, seed=1)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(96, D_FEAT)).astype(np.float32)
    y = np.where(X[:, 0] > 0, 1.0, -1.0).astype(np.float32)
    d48 = DataDispatcher(ClassificationDataHandler(X, y, test_size=0.0),
                         n=48).stacked()
    kw = dict(device="cpu", mailbox_slots=4)
    assert Undeclared(handler, big, d48, **kw)._compact_cap is None
    assert tsimulation.PassThroughGossipSimulator(
        handler, big, d48, **kw)._compact_cap is not None


def test_memory_budget_counts_aux_and_part_ages():
    key = jax.random.PRNGKey(0)
    cases = (("CacheNeighGossipSimulator", pegasos(), True,
              dict(history_dtype="int8")),
             ("TokenizedPartitioningGossipSimulator",
              logreg("partitioned", CreateModelMode.UPDATE), False,
              dict(token_account=tflow.SimpleTokenAccount(C=1))),
             ("PENSGossipSimulator", logreg(), False, dict(n_sampled=3)))
    for name, handlers, signed, kw in cases:
        jsim, tsim = make(name, handlers, topology("ba"),
                          small_data(signed=signed), key, **kw)
        got, want = tsim.memory_budget(), jsim.memory_budget()
        state = to_port_state(tsim, jsim.init_nodes(key))
        held = sum(t.numel() * t.element_size() for t in state.aux.values())
        assert got["aux_bytes"] == held > 0, name
        assert got["history_ages_bytes"] == want["history_ages_bytes"], name
        assert got["history_depth"] == want["history_depth"], name
        assert got["total_bytes"] >= held
