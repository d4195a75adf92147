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
    with pytest.raises(NotImplementedError):
        tcore.Topology.random_regular(10, 3, backend="native")
    with pytest.raises(NotImplementedError):
        tcore.Topology.random_regular(2048, 4, backend="auto")
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
    with pytest.raises(NotImplementedError):
        tcore.Topology.barabasi_albert(10, 3, backend="native")
    with pytest.raises(NotImplementedError):
        tcore.Topology.barabasi_albert(2048, 3, backend="auto")
    for m in (0, 10):
        with pytest.raises(ValueError):
            tcore.Topology.barabasi_albert(10, m)


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


def test_mixing_refuses_a_sparse_topology():
    with pytest.raises(NotImplementedError):
        tcore.uniform_mixing(object())


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
