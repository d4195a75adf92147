"""The sparse slice of the port against the JAX package: the native graph
generators, ``Topology.erdos_renyi``, :class:`SparseTopology`,
:class:`SparseMixing`, the neighbour table and the chaos pair order, the
CSR and slot peer draws, and the vanilla engine over a sparse topology
under the JAX draw oracle, on every deliver path, under chaos (the slot
form), with probes and sentinels.

Small sizes throughout (48-64 nodes, degree 4-6); the engine runs are
held as ``torch_pairs.run_both`` holds them: accounting and both boxes
exactly, params within 1e-5 (PERF.md section 2).
"""

import logging
import warnings

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import torch_pairs as tp
from gossipy_tpu import core as jcore
from gossipy_tpu import native as jnative
from gossipy_tpu.simulation import faults as jfaults
from gossipy_tpu.simulation import nodes as jnodes
from gossipy_tpu_torch import core as tcore
from gossipy_tpu_torch import native as tnative
from gossipy_tpu_torch.random import K_PEER, TorchDraws
from gossipy_tpu_torch.simulation import faults as tfaults
from gossipy_tpu_torch.simulation import nodes as tnodes
from gossipy_tpu_torch.simulation.faults import ChaosConfig, ChurnProcess, \
    PartitionEpisode
from torch_oracle import JaxDraws

N, DEG, ROUNDS = 48, 4, 6


def sparse_data(n=N):
    return tp.small_data(n=n)


# -- the native generators ---------------------------------------------------

DENSE_CASES = [("random_regular", (50, 4, 3)), ("random_regular", (64, 6, 1)),
               ("random_regular", (31, 2, 9)),
               ("barabasi_albert", (40, 3, 1)),
               ("barabasi_albert", (64, 5, 42)),
               ("barabasi_albert", (12, 11, 0)),
               ("erdos_renyi", (30, 0.2, 5)), ("erdos_renyi", (64, 0.05, 42)),
               ("erdos_renyi", (17, 0.7, 2)),
               ("ring", (9, 2)), ("ring", (10, 5)), ("ring", (64, 1))]
EDGE_CASES = [("random_regular_edges", (50, 4, 3)),
              ("random_regular_edges", (64, 6, 1)),
              ("random_regular_edges", (2048, 20, 42)),
              ("barabasi_albert_edges", (40, 3, 1)),
              ("barabasi_albert_edges", (64, 5, 42)),
              ("barabasi_albert_edges", (4141, 10, 42)),
              ("erdos_renyi_edges", (300, 0.02, 5)),
              ("erdos_renyi_edges", (64, 0.1, 42)),
              ("erdos_renyi_edges", (2000, 0.004, 7))]


@pytest.mark.parametrize("fn,args", DENSE_CASES + EDGE_CASES)
def test_native_generator_equals_jax(fn, args):
    got = getattr(tnative, fn)(*args)
    want = getattr(jnative, fn)(*args)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_graphgen_source_is_the_references():
    assert tnative.SRC.read_bytes() == open(jnative._SRC, "rb").read()
    assert tnative.library_path().parent.name == "_build"
    assert tnative.available()


def test_native_edge_digests_are_pinned():
    """The digests ``chip_smoke.py`` holds the card machine's build to
    are those of the JAX package's generator here."""
    for (kind, args), want in chip_smoke.NATIVE_DIGESTS.items():
        fn = {"random_regular": "random_regular_edges",
              "barabasi_albert": "barabasi_albert_edges"}[kind]
        assert chip_smoke.edge_digest(getattr(jnative, fn)(*args)) == want
        assert chip_smoke.edge_digest(getattr(tnative, fn)(*args)) == want


def test_impossible_native_graphs_raise():
    with pytest.raises(ValueError):
        tnative.random_regular_edges(9, 3)
    with pytest.raises(ValueError):
        tnative.random_regular(4, 4)
    with pytest.raises(ValueError):
        tnative.barabasi_albert_edges(5, 5)


@pytest.mark.parametrize("gen,arg", [("random_regular", 4),
                                     ("barabasi_albert", 3),
                                     ("erdos_renyi", 0.003)])
def test_auto_backend_at_threshold_is_native(gen, arg, caplog,
                                             monkeypatch):
    """``"auto"`` at ``NATIVE_THRESHOLD`` nodes gives the JAX default's
    (native) edge set and logs the JAX package's warning (the package
    logger's ``DuplicateFilter`` drops a message it has seen, as the JAX
    one does: each case starts from a filter that has seen none)."""
    import gossipy_tpu_torch
    for flt in gossipy_tpu_torch.LOG.filters:
        if isinstance(flt, gossipy_tpu_torch.DuplicateFilter):
            monkeypatch.setattr(flt, "_seen", set())
    n = tcore.Topology.NATIVE_THRESHOLD
    with caplog.at_level(logging.WARNING, logger="gossipy_tpu_torch"):
        got = getattr(tcore.Topology, gen)(n, arg, seed=7)
    assert "selected the native generator" in caplog.text
    want = getattr(jcore.Topology, gen)(n, arg, seed=7)
    np.testing.assert_array_equal(got.adjacency, np.asarray(want.adjacency))
    np.testing.assert_array_equal(
        got.adjacency, getattr(tcore.Topology, gen)(
            n, arg, seed=7, backend="native").adjacency)


@pytest.mark.parametrize("n,p,seed", [(30, 0.2, 1), (64, 0.08, 42),
                                      (12, 1.0, 3), (12, 0.0, 3),
                                      (40, 0.5, 9)])
def test_erdos_renyi_equals_networkx(n, p, seed):
    got = tcore.Topology.erdos_renyi(n, p, seed=seed)
    want = jcore.Topology.erdos_renyi(n, p, seed=seed, backend="networkx")
    np.testing.assert_array_equal(got.adjacency, np.asarray(want.adjacency))
    np.testing.assert_array_equal(
        got.adjacency, tcore.Topology.erdos_renyi(n, p, seed=seed,
                                                  backend="networkx")
        .adjacency)


def test_without_the_library_native_raises(monkeypatch):
    """Without a compiler ``"native"`` and every sparse constructor
    raise; ``"auto"`` keeps networkx's algorithm."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_error", "no g++ here")
    assert not tnative.available()
    with pytest.raises(RuntimeError, match="no g"):
        tcore.Topology.random_regular(10, 3, backend="native")
    with pytest.raises(RuntimeError):
        tcore.SparseTopology.barabasi_albert(10, 3)
    big = tcore.Topology.NATIVE_THRESHOLD
    np.testing.assert_array_equal(
        tcore.Topology.random_regular(big, 2, seed=1).adjacency,
        tcore.Topology.random_regular(big, 2, seed=1,
                                      backend="networkx").adjacency)


# -- SparseTopology and SparseMixing ------------------------------------------

SPARSE_CTORS = {
    "random_regular": lambda m: m.SparseTopology.random_regular(48, 4, 5),
    "erdos_renyi": lambda m: m.SparseTopology.erdos_renyi(64, 0.08, 3),
    "barabasi_albert": lambda m: m.SparseTopology.barabasi_albert(60, 3, 2),
    "ring": lambda m: m.SparseTopology.ring(12, 2),
    "ring_antipodal": lambda m: m.SparseTopology.ring(10, 5),
    "from_dense": lambda m: m.SparseTopology.from_dense(
        m.Topology.random_regular(30, 4, seed=1, backend="networkx")),
    "edges": lambda m: m.SparseTopology(
        10, np.array([[0, 3], [3, 1], [2, 9], [9, 0]])),
}


@pytest.mark.parametrize("kind", sorted(SPARSE_CTORS))
def test_sparse_topology_equals_jax(kind):
    got, want = SPARSE_CTORS[kind](tcore), SPARSE_CTORS[kind](jcore)
    for f in ("indices", "indptr", "degrees"):
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype == np.int32, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.num_nodes == want.num_nodes == got.size()
    for node in (0, 1, got.num_nodes - 1):
        assert got.get_peers(node) == want.get_peers(node)
        assert got.size(node) == want.size(node)
    np.testing.assert_array_equal(got.to_dense().adjacency,
                                  np.asarray(want.to_dense().adjacency))
    with pytest.raises(AttributeError):
        got.adjacency


def test_csr_on_is_made_once_per_device():
    topo = tcore.SparseTopology.random_regular(48, 4, 5)
    csr = topo.csr_on("cpu")
    assert csr is topo.csr_on(torch.device("cpu"))
    np.testing.assert_array_equal(csr.indptr.numpy(), topo.indptr)
    np.testing.assert_array_equal(csr.indices.numpy(), topo.indices)
    assert csr.degrees.dtype == torch.int64


@pytest.mark.parametrize("mixing", ["uniform_mixing",
                                    "metropolis_hastings_mixing"])
@pytest.mark.parametrize("kind", ["random_regular", "barabasi_albert",
                                  "edges"])
def test_sparse_mixing_equals_jax(mixing, kind):
    got = getattr(tcore, mixing)(SPARSE_CTORS[kind](tcore))
    want = getattr(jcore, mixing)(SPARSE_CTORS[kind](jcore))
    assert isinstance(got, tcore.SparseMixing)
    for f in ("edge_w", "self_w", "rows", "senders"):
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.num_nodes == want.num_nodes
    # The same weights as the dense matrix of the same graph.
    dense = getattr(tcore, mixing)(SPARSE_CTORS[kind](tcore).to_dense())
    np.testing.assert_allclose(dense[got.rows, got.senders], got.edge_w,
                               rtol=1e-6)
    np.testing.assert_allclose(np.diagonal(dense), got.self_w, rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("kind", ["random_regular", "barabasi_albert",
                                  "edges", "dense"])
def test_neighbor_table_and_pairs_equal_jax(kind):
    if kind == "dense":
        got = tcore.Topology.barabasi_albert(30, 3, seed=4)
        want = jcore.Topology(got.adjacency)
    else:
        got, want = SPARSE_CTORS[kind](tcore), SPARSE_CTORS[kind](jcore)
    np.testing.assert_array_equal(
        tnodes.build_neighbor_table(got, reject_duplicates=True),
        jnodes.build_neighbor_table(want, reject_duplicates=True))
    for a, b in zip(tfaults._undirected_pairs(got),
                    jfaults._undirected_pairs(want)):
        np.testing.assert_array_equal(a, b)
    if kind != "dense":
        # The canonical pair order is the dense one.
        for a, b in zip(tfaults._undirected_pairs(got),
                        tfaults._undirected_pairs(got.to_dense())):
            np.testing.assert_array_equal(a, b)


def test_duplicated_neighbour_raises():
    topo = tcore.SparseTopology(5, np.array([[0, 1], [1, 0], [2, 3]]))
    with pytest.raises(ValueError, match="more than once"):
        tnodes.build_neighbor_table(topo, reject_duplicates=True)
    assert tnodes.build_neighbor_table(topo).shape == (5, 2)


# -- the draws ---------------------------------------------------------------

def isolated_topologies():
    """Sparse topologies with isolated nodes (peer -1) among the rest."""
    return (tcore.SparseTopology(12, np.array([[0, 1], [1, 2], [2, 5],
                                               [7, 8], [8, 0]])),
            jcore.SparseTopology(12, np.array([[0, 1], [1, 2], [2, 5],
                                               [7, 8], [8, 0]])))


@pytest.mark.parametrize("r,sub,purpose,fold", [(0, 0, K_PEER, 0),
                                                (3, 1, K_PEER, 0),
                                                (5, 0, 9200, 0),
                                                (2, 0, K_PEER, 3)])
def test_csr_peer_draw_equals_jax(r, sub, purpose, fold):
    """The oracle's CSR draw is ``SparseTopology.sample_peers`` under the
    JAX engine's key, isolated nodes ``-1``; it is not the dense
    categorical over the same graph."""
    base = jax.random.PRNGKey(4)
    draws = JaxDraws(base)
    for ttopo, jtopo in (isolated_topologies(),
                         (SPARSE_CTORS["barabasi_albert"](tcore),
                          SPARSE_CTORS["barabasi_albert"](jcore))):
        got = draws.csr_peers(r, ttopo.csr_on("cpu"), sub=sub,
                              purpose=purpose, fold=fold)
        key = draws._hook_key(r, purpose, sub)
        if fold:
            key = jax.random.fold_in(key, fold)
        want = np.asarray(jtopo.sample_peers(key))
        np.testing.assert_array_equal(got.numpy(), want)
        assert ((got == -1).numpy() == (ttopo.degrees == 0)).all()
    dense = draws.peers(r, torch.as_tensor(ttopo.to_dense().adjacency),
                        sub=sub, purpose=purpose, fold=fold)
    assert not torch.equal(dense, got)


@pytest.mark.parametrize("r,sub", [(2, 0), (3, 1)])
def test_slot_draw_equals_jax_chaos_draw(r, sub):
    """The oracle's slot draw is the JAX engine's sparse chaos peer draw
    (``_chaos_masked_peers``, slot form) for the same round; a node whose
    every edge is cut gets ``-1``."""
    jtopo = jcore.SparseTopology.random_regular(N, DEG, seed=5)
    ttopo = tcore.SparseTopology.random_regular(N, DEG, seed=5)
    cfg = ChaosConfig(partitions=(PartitionEpisode(
        components=((0,), tuple(range(1, 20))), start=1, stop=5),))
    data = sparse_data()
    jsim, tsim = tp.make_pair(jtopo, ttopo, data, data,
                              jax.random.PRNGKey(1), chaos=cfg)
    assert jsim._chaos_edge_form == "slot"
    base = jax.random.PRNGKey(8)
    draws = JaxDraws(base)
    jbase = base if sub == 0 else draws._key(r, 11, sub)   # K_FIRE
    want = np.asarray(jsim._chaos_masked_peers(
        jsim._round_key(jbase, r, K_PEER), r))
    tsim.draws = draws
    got = tsim._chaos_masked_peers(r, sub=sub)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == -1


def test_torch_draws_csr_peers_are_the_dense_draws():
    """``TorchDraws``' CSR draw takes the same neighbour as its dense draw
    over the same graph, from the same seed, isolated nodes ``-1``; it
    reads the CSR arrays and copies no adjacency."""
    ttopo, _ = isolated_topologies()
    a, b = TorchDraws(3), TorchDraws(3)
    adj = torch.as_tensor(ttopo.to_dense().adjacency)
    for r in range(4):
        got = a.csr_peers(r, ttopo.csr_on("cpu"))
        np.testing.assert_array_equal(got.numpy(), b.peers(r, adj).numpy())
    assert not a._neighbours


# -- the vanilla engine over a sparse topology, under the oracle -------------

def sparse_pair(key, topo="random_regular", n=N, **kw):
    ctor = {"random_regular": lambda m: m.SparseTopology.random_regular(
                n, DEG, seed=5),
            "barabasi_albert": lambda m: m.SparseTopology.barabasi_albert(
                n, 3, seed=2)}[topo]
    data = sparse_data(n)
    return tp.make_pair(ctor(jcore), ctor(tcore), data, data, key, **kw)


@pytest.mark.parametrize("path", sorted(tp.PATHS))
def test_sparse_vanilla_matches_jax(path):
    """Every deliver path over a 48-node sparse regular graph, the same
    path in both engines: the plain path's automatic compaction (sized
    from the CSR fan-in) takes the JAX engine's capacity."""
    key = jax.random.PRNGKey(6)
    fused, cap = tp.PATHS[path]
    jsim, tsim = sparse_pair(key, fused_merge=fused, compact_deliver=cap)
    assert tsim._adj is None and tsim._csr is not None
    assert tsim._compact_cap == jsim._compact_cap and tsim.K == jsim.K
    trep = tp.run_both(jsim, tsim, key)
    assert trep.sent_messages > 0
    if path == "plain":
        assert tsim._compact_cap is not None
        assert trep.compact_slots_per_round.sum() > 0


def test_sparse_fan_in_is_the_dense_fan_in():
    """The CSR scatter gives the dense column sum: the same mailbox
    slots, compaction capacity and expected fan-in."""
    key = jax.random.PRNGKey(2)
    _, sparse = sparse_pair(key, topo="barabasi_albert", n=64)
    dense_topo = sparse.topology.to_dense()
    _, dense = tp.make_pair(jcore.Topology(dense_topo.adjacency), dense_topo,
                            sparse_data(64), sparse_data(64), key)
    np.testing.assert_allclose(sparse._lam_vector(), dense._lam_vector(),
                               rtol=1e-12)
    assert sparse.K == dense.K and sparse._compact_cap == dense._compact_cap


SPARSE_CHAOS = {
    "partition": ChaosConfig(partitions=(PartitionEpisode(
        components=(tuple(range(N // 2)), tuple(range(N // 2, N))),
        start=1, stop=4),)),
    "churn": ChaosConfig(churn=ChurnProcess(keep_frac=0.5, start=1, stop=6,
                                            period=2, seed=3)),
}


@pytest.mark.parametrize("kind,path", [("partition", "multi"),
                                       ("churn", "plain")])
def test_sparse_chaos_matches_jax(kind, path):
    """Partitions and churn over a sparse topology: peers drawn over the
    alive slots (the JAX engine's slot form), with probes and sentinels;
    the run, ``failed_chaos`` and every telemetry array equal JAX's."""
    key = jax.random.PRNGKey(10)
    fused, cap = tp.PATHS[path]
    jsim, tsim = sparse_pair(key, fused_merge=fused, compact_deliver=cap,
                             probes=True, sentinels=True,
                             chaos=SPARSE_CHAOS[kind], drop_prob=0.1)
    assert jsim._chaos_edge_form == "slot"
    jst = jsim.init_nodes(key, common_init=True)
    tst = tp.to_port_state(tsim, jst)
    jst, jrep = jsim.start(jst, n_rounds=ROUNDS, key=key, donate_state=False)
    tst, trep = tsim.start(tst, n_rounds=ROUNDS)
    tp.assert_same_run(jsim, tsim, jst, tst, jrep, trep)
    tp.assert_same_telemetry(jrep, trep)
    assert trep.sent_messages > 0


def test_sparse_probes_and_sentinels_match_jax():
    """Probes and sentinels over a sparse hub graph (the expected fan-in
    the probes read is the CSR scatter), PUSH_PULL on the single-pass
    deliver."""
    key = jax.random.PRNGKey(12)
    jsim, tsim = sparse_pair(key, topo="barabasi_albert", n=64,
                             fused_merge="multi", probes=True,
                             sentinels=True,
                             protocol=tcore.AntiEntropyProtocol.PUSH_PULL)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jst = jsim.init_nodes(key, common_init=False)
        tst = tp.to_port_state(tsim, jst)
        jst, jrep = jsim.start(jst, n_rounds=ROUNDS, key=key,
                               donate_state=False)
        tst, trep = tsim.start(tst, n_rounds=ROUNDS)
    tp.assert_same_run(jsim, tsim, jst, tst, jrep, trep)
    tp.assert_same_telemetry(jrep, trep)


def test_construction_at_50k_makes_no_dense_matrix(monkeypatch):
    """A 50,000-node sparse topology, its mixing and a simulator over it
    build in seconds; nothing builds an ``[N, N]``: every numpy and torch
    allocation of N^2 elements is refused while they are built."""
    import time

    from gossipy_tpu_torch.examples import scale

    n = 50_000
    big = n * n // 4

    def guard(fn):
        def wrapped(*args, **kwargs):
            shape = args[0] if args else kwargs.get("shape", ())
            size = int(np.prod(shape)) if not isinstance(shape, int) \
                else shape
            if size >= big:
                raise AssertionError(f"an [N, N] allocation: {shape}")
            return fn(*args, **kwargs)
        return wrapped

    for mod, name in ((np, "zeros"), (np, "ones"), (np, "empty"),
                      (np, "full"), (torch, "zeros"), (torch, "ones"),
                      (torch, "empty"), (torch, "full")):
        monkeypatch.setattr(mod, name, guard(getattr(mod, name)))
    t0 = time.perf_counter()
    topo = tcore.SparseTopology.random_regular(n, 20, seed=42)
    mixing = tcore.uniform_mixing(topo)
    sim = scale.build_vanilla(n, 8, topo, device="cpu")
    took = time.perf_counter() - t0
    assert topo.indices.shape == (n * 20,)
    assert mixing.edge_w.shape == (n * 20,)
    assert sim._adj is None and sim.K >= 1
    assert took < 30, took
    with pytest.raises(AttributeError):
        topo.adjacency
