"""The port's topology constructors and delay models against the JAX
package's: ``random_regular`` and ``barabasi_albert`` (the edge sets
networkx gives), ``ring``, ``get_peers`` and ``size``; the uniform and
Metropolis-Hastings mixing matrices and their per-node weight rows; the
delays' ``max_delay`` and their draws, through the JAX draw oracle, equal
to the JAX ``sample`` under the same key."""

import jax
import numpy as np
import pytest
import torch

from gossipy_tpu import core as jcore
from gossipy_tpu_torch import core as tcore
from gossipy_tpu_torch.random import K_DELAY, K_REPLY_DELAY, TorchDraws
from torch_oracle import JaxDraws


@pytest.mark.parametrize("n,d,seed", [(100, 20, 42), (10, 3, 0),
                                      (31, 4, 7)])
def test_random_regular_equals_networkx(n, d, seed):
    got = tcore.Topology.random_regular(n, d, seed=seed)
    want = jcore.Topology.random_regular(n, d, seed=seed, backend="networkx")
    np.testing.assert_array_equal(got.adjacency, want.adjacency)
    assert (got.degrees == d).all()
    assert (got.adjacency == got.adjacency.T).all()


def test_random_regular_refuses_what_it_cannot_build():
    """The impossible ``(n, d)`` raise on either backend; the native
    backend builds the JAX package's native edge set."""
    np.testing.assert_array_equal(
        tcore.Topology.random_regular(10, 3, backend="native").adjacency,
        np.asarray(jcore.Topology.random_regular(10, 3,
                                                 backend="native").adjacency))
    with pytest.raises(ValueError):
        tcore.Topology.random_regular(9, 3, backend="native")
    with pytest.raises(ValueError):
        tcore.Topology.random_regular(9, 3)   # n * d odd
    with pytest.raises(ValueError):
        tcore.Topology.random_regular(4, 4)   # d >= n
    assert not tcore.Topology.random_regular(6, 0).adjacency.any()


@pytest.mark.parametrize("n,m,seed", [(200, 10, 42), (50, 3, 1),
                                      (31, 1, 7), (12, 11, 0)])
def test_barabasi_albert_equals_networkx(n, m, seed):
    got = tcore.Topology.barabasi_albert(n, m, seed=seed)
    want = jcore.Topology.barabasi_albert(n, m, seed=seed,
                                          backend="networkx")
    np.testing.assert_array_equal(got.adjacency, want.adjacency)
    assert (got.adjacency == got.adjacency.T).all()
    assert got.degrees.sum() == 2 * m * (n - m)   # m edges a new node


def test_barabasi_albert_refuses_what_it_cannot_build():
    """``m`` outside ``[1, n)`` raises on either backend; the native
    backend builds the JAX package's native edge set."""
    np.testing.assert_array_equal(
        tcore.Topology.barabasi_albert(10, 3, backend="native").adjacency,
        np.asarray(jcore.Topology.barabasi_albert(10, 3,
                                                  backend="native").adjacency))
    for m in (0, 10):
        with pytest.raises(ValueError):
            tcore.Topology.barabasi_albert(10, m)
        with pytest.raises(ValueError):
            tcore.Topology.barabasi_albert(10, m, backend="native")


@pytest.mark.parametrize("kind", ["ba", "regular", "ring", "clique"])
def test_mixing_matrices_match_jax(kind):
    build = {"ba": lambda m: m.Topology.barabasi_albert(40, 3, seed=2),
             "regular": lambda m: m.Topology.random_regular(30, 4, seed=1),
             "ring": lambda m: m.Topology.ring(9, 2),
             "clique": lambda m: m.Topology.clique(6)}[kind]
    tt, jt = build(tcore), build(jcore)
    for name in ("uniform_mixing", "metropolis_hastings_mixing"):
        got = getattr(tcore, name)(tt)
        want = np.asarray(getattr(jcore, name)(jt))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-6)
        np.testing.assert_array_equal(
            tcore.mixing_weight_rows(got, tt),
            np.asarray(jcore.mixing_weight_rows(want, jt)))
    mh = tcore.metropolis_hastings_mixing(tt)
    np.testing.assert_array_equal(mh, mh.T)


@pytest.mark.parametrize("n,k", [(7, 1), (10, 3)])
def test_ring_and_queries_match_jax(n, k):
    got, want = tcore.Topology.ring(n, k), jcore.Topology.ring(n, k)
    np.testing.assert_array_equal(got.adjacency, want.adjacency)
    assert got.size() == want.size() == n
    for node in range(n):  # node 0 reports its degree too
        assert got.size(node) == want.size(node) == 2 * k
        assert got.get_peers(node) == want.get_peers(node)


def test_max_delay_matches_jax():
    for t, j in ((tcore.ConstantDelay(7), jcore.ConstantDelay(7)),
                 (tcore.UniformDelay(3, 40), jcore.UniformDelay(3, 40)),
                 (tcore.LinearDelay(0.25, 5), jcore.LinearDelay(0.25, 5))):
        for size in (1, 58, 73418):
            assert t.max_delay(size) == j.max_delay(size)
    with pytest.raises(ValueError):
        tcore.UniformDelay(5, 2)


@pytest.mark.parametrize("purpose,sub", [(K_DELAY, 0), (K_DELAY, 1),
                                         (K_REPLY_DELAY * 101 + 3, 0)])
def test_delay_draws_match_jax_sample(purpose, sub):
    """Under the oracle, ``sample(draws, r, purpose, ..., sub)`` is the JAX
    ``sample`` under ``fold_in(_round_key(r, purpose), sub)``."""
    base = jax.random.PRNGKey(9)
    draws = JaxDraws(base)
    n, size, r = 50, 58, 3
    key = jax.random.fold_in(jax.random.fold_in(base, r), purpose)
    if sub:
        key = jax.random.fold_in(key, sub)
    for t, j in ((tcore.UniformDelay(0, 10), jcore.UniformDelay(0, 10)),
                 (tcore.UniformDelay(40, 260), jcore.UniformDelay(40, 260)),
                 (tcore.LinearDelay(0.5, 3), jcore.LinearDelay(0.5, 3)),
                 (tcore.ConstantDelay(4), jcore.ConstantDelay(4))):
        got = t.sample(draws, r, purpose, n, size, torch.device("cpu"), sub)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(j.sample(key, (n,), size)))


def test_torch_draws_cover_the_new_draws():
    """The default provider's delays, eval subsets and async periods have
    the documented ranges."""
    d = TorchDraws(3)
    cpu = torch.device("cpu")
    v = tcore.UniformDelay(2, 5).sample(d, 0, K_DELAY, 400, 1, cpu)
    assert v.min() == 2 and v.max() == 5
    idx = d.eval_subset(0, 20, 7, cpu)
    assert idx.shape == (7,) and len(set(idx.tolist())) == 7
    assert 0 <= idx.min() and idx.max() < 20
    period = d.init_period(500, 100, cpu)
    assert period.dtype == torch.int32 and period.min() >= 1
    assert 90 < float(period.float().mean()) < 110


# -- the public peer draw ----------------------------------------------------

def peer_draws(kind, gen, topo):
    if kind == "dense":
        return topo.sample_peers(gen)
    if kind == "csr":
        return tcore.SparseTopology.from_dense(topo).sample_peers(gen)
    return tcore.sample_peers(gen, topo.adjacency)


@pytest.mark.parametrize("kind", ["dense", "csr", "function"])
def test_sample_peers_draws_a_neighbour_per_node(kind):
    """int32 ``[N]``, the reference's dtype, each a neighbour of its
    node."""
    topo = tcore.Topology.barabasi_albert(40, 2, seed=3)
    got = peer_draws(kind, torch.Generator().manual_seed(0), topo)
    want = jcore.Topology(topo.adjacency).sample_peers(jax.random.PRNGKey(0))
    assert got.dtype == torch.int32 and str(want.dtype) == "int32"
    assert tuple(got.shape) == tuple(want.shape) == (40,)
    for i, p in enumerate(got.tolist()):
        assert topo.adjacency[i, p]


@pytest.mark.parametrize("kind", ["dense", "csr", "function"])
def test_sample_peers_gives_minus_one_to_an_isolated_node(kind):
    adj = np.zeros((6, 6), dtype=bool)
    for a, b in ((0, 1), (1, 2), (2, 0), (4, 5)):
        adj[a, b] = adj[b, a] = True
    topo = tcore.Topology(adj)
    got = peer_draws(kind, torch.Generator().manual_seed(1), topo)
    assert got[3] == -1 and (got[[0, 1, 2, 4, 5]] >= 0).all()
    jgot = np.asarray(jcore.Topology(adj).sample_peers(jax.random.PRNGKey(1)))
    assert jgot[3] == -1
    none = peer_draws(kind, torch.Generator().manual_seed(1),
                      tcore.Topology(np.zeros((4, 4), dtype=bool)))
    assert none.dtype == torch.int32 and none.tolist() == [-1] * 4


@pytest.mark.parametrize("kind", ["dense", "csr"])
def test_sample_peers_is_uniform_over_the_neighbours(kind):
    """Over 3000 draws at a fixed seed, each node's neighbours by a
    chi-square test (p > 0.001) on a graph of mixed degrees."""
    from scipy import stats
    topo = tcore.Topology.barabasi_albert(30, 2, seed=5)
    gen = torch.Generator().manual_seed(11)
    draws = 3000
    counts = np.zeros((30, 30))
    for _ in range(draws):
        counts[np.arange(30), peer_draws(kind, gen, topo).numpy()] += 1
    assert (counts[~topo.adjacency] == 0).all()
    deg = topo.degrees.astype(float)
    expected = (draws / deg)[:, None] * topo.adjacency
    chi2 = float((((counts - expected) ** 2)[topo.adjacency]
                  / expected[topo.adjacency]).sum())
    dof = int((deg - 1).sum())
    assert stats.chi2.sf(chi2, dof) > 1e-3, (chi2, dof)


def test_sample_peers_is_the_engine_s_draw():
    """Equal to ``TorchDraws(generator).peers`` and ``csr_peers`` for the
    same generator state, and it advances the stream as they do."""
    topo = tcore.Topology.random_regular(24, 5, seed=2)
    sparse = tcore.SparseTopology.from_dense(topo)
    adj = torch.as_tensor(topo.adjacency)
    for seed in (0, 7):
        a, b, c, d = (torch.Generator().manual_seed(seed) for _ in range(4))
        got = tcore.sample_peers(a, topo.adjacency)
        want = TorchDraws(generator=b).peers(0, adj)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        got_csr = sparse.sample_peers(c)
        want_csr = TorchDraws(generator=d).csr_peers(0, sparse.csr_on("cpu"))
        np.testing.assert_array_equal(got_csr.numpy(), want_csr.numpy())
        for g in (b, c, d):
            assert torch.equal(a.get_state(), g.get_state())
    draws = TorchDraws(generator=torch.Generator().manual_seed(4))
    assert draws.seed == 4


def test_dense_and_csr_sample_equal_peers():
    """One graph, one generator state: the dense and the CSR draw give
    the same peers, round after round."""
    topo = tcore.Topology.erdos_renyi(50, 0.1, seed=1)
    sparse = tcore.SparseTopology.from_dense(topo)
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    for _ in range(5):
        np.testing.assert_array_equal(topo.sample_peers(g1).numpy(),
                                      sparse.sample_peers(g2).numpy())
