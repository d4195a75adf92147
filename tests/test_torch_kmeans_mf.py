"""The port's k-means and matrix-factorisation handlers against the JAX
package's.

- ``greedy_match`` gives the JAX permutation on random costs (batched
  over rows) and on a crafted cost where greedy and exact differ;
  ``exact_match`` is scipy's optimum.
- ``KMeansHandler``: ``update`` (masked samples), ``merge`` (naive;
  Hungarian over stacked rows, which matches greedily as the JAX
  engine's traced merge does; one unstacked pair, which matches exactly
  as the JAX eager merge does) and ``evaluate`` (NMI) against ``jax.vmap``
  of the JAX handler; centroids within 1e-5, ages exactly, NMI within
  1e-6.
- ``MFHandler``: the leaf order of the flat row against
  ``jax.tree_util.tree_flatten``; ``update`` over masked rating slots,
  ``merge`` (item state only, age-weighted, the receiver's age) and
  ``evaluate`` (RMSE) against ``jax.vmap``; params within 1e-5, ages
  exactly, RMSE within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipy_tpu.handlers import KMeansHandler, MFHandler
from gossipy_tpu.handlers.base import ModelState as JModelState
from gossipy_tpu.handlers.base import PeerModel as JPeerModel
from gossipy_tpu.handlers.kmeans import exact_match, greedy_match
from gossipy_tpu.utils import nmi, rmse
from gossipy_tpu_torch import convert
from gossipy_tpu_torch.handlers import KMeansHandler as TKMeansHandler
from gossipy_tpu_torch.handlers import MFHandler as TMFHandler
from gossipy_tpu_torch.handlers import ModelState as TModelState
from gossipy_tpu_torch.handlers import PeerModel as TPeerModel
from gossipy_tpu_torch.handlers import exact_match as texact_match
from gossipy_tpu_torch.handlers import greedy_match as tgreedy_match
from gossipy_tpu_torch.utils import nmi as tnmi
from gossipy_tpu_torch.utils import rmse as trmse

torch.set_num_threads(1)

N, S, K, D = 6, 12, 3, 4
# Greedy locks the cheap (0, 0) pair and pays 1 + 18; the optimum crosses
# over and pays 8 + 9 (c1 = [0, 10], c2 = [1, -8] in one dimension).
CRAFTED = np.array([[1.0, 8.0], [9.0, 18.0]], np.float32)


def t(*arrays):
    out = tuple(torch.from_numpy(np.array(a)) for a in arrays)
    return out if len(out) > 1 else out[0]


# -- matching ---------------------------------------------------------------

def test_greedy_match_equals_jax_permutation():
    rng = np.random.default_rng(0)
    costs = rng.random((40, 5, 5)).astype(np.float32)
    costs[0] = 0.5                      # all tied: first flat index wins
    costs[1, :, 2] = 0.0                # a tied column
    want = np.stack([np.asarray(greedy_match(jnp.asarray(c)))
                     for c in costs])
    np.testing.assert_array_equal(tgreedy_match(t(costs)).numpy(), want)
    np.testing.assert_array_equal(tgreedy_match(t(costs[3])).numpy(),
                                  want[3])


def test_crafted_cost_greedy_and_exact_differ():
    greedy = tgreedy_match(t(CRAFTED)).numpy()
    exact = texact_match(t(CRAFTED))
    np.testing.assert_array_equal(greedy, np.asarray(
        greedy_match(jnp.asarray(CRAFTED))))
    np.testing.assert_array_equal(exact, exact_match(CRAFTED))
    assert greedy.tolist() == [0, 1] and exact.tolist() == [1, 0]
    assert exact.dtype == np.int32


# -- k-means ------------------------------------------------------------------

def kmeans_pair(matching="naive"):
    return (KMeansHandler(k=K, dim=D, alpha=0.1, matching=matching),
            TKMeansHandler(k=K, dim=D, alpha=0.1, matching=matching))


def blobs(seed=1):
    """Samples around three centres; node 1 has masked samples, node 5
    none at all; integer labels of the centre."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(scale=4.0, size=(K, D))
    y = rng.integers(0, K, (N, S))
    X = (centres[y] + rng.normal(size=(N, S, D))).astype(np.float32)
    mask = np.ones((N, S), np.float32)
    mask[1, ::3] = 0.0
    mask[5] = 0.0
    return X, y.astype(np.int64), mask


def centroids(seed, n=N):
    return np.random.default_rng(seed).normal(
        scale=3.0, size=(n, K, D)).astype(np.float32)


def port_state(th, c, ages):
    return TModelState(convert.params_from_jax(c, th.layout), (), t(ages))


def views(th, params):
    return convert.params_to_numpy(params, th.layout)[""]


def test_kmeans_update_and_evaluate_match_jax():
    jh, th = kmeans_pair()
    X, y, mask = blobs()
    c = centroids(2)
    ages = np.arange(N, dtype=np.int32)
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    want = jax.vmap(jh.update)(JModelState(jnp.asarray(c), (),
                                           jnp.asarray(ages)),
                               (X, y, mask), keys)
    got = th.update(port_state(th, c, ages), t(X, y, mask))
    np.testing.assert_allclose(views(th, got.params), np.asarray(want.params),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.n_updates.numpy(),
                                  np.asarray(want.n_updates))
    np.testing.assert_array_equal(views(th, got.params)[5], c[5])
    mask[5, :4] = 1.0
    want_m = jax.vmap(jh.evaluate)(want, (X, y, mask))
    got_m = th.evaluate(got, t(X, y, mask))
    assert sorted(got_m) == ["nmi"]
    np.testing.assert_allclose(got_m["nmi"].numpy(),
                               np.asarray(want_m["nmi"]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("matching", ["naive", "hungarian"])
def test_kmeans_stacked_merge_matches_jax_engine_merge(matching):
    jh, th = kmeans_pair(matching)
    c1, c2 = centroids(3), centroids(4)
    a1 = np.array([0, 1, 2, 3, 4, 5], np.int32)
    a2 = np.array([5, 4, 3, 2, 1, 0], np.int32)
    # The JAX engine vmaps the merge inside its traced round: greedy.
    want = jax.jit(jax.vmap(jh.merge))(
        JModelState(jnp.asarray(c1), (), jnp.asarray(a1)),
        JPeerModel(jnp.asarray(c2), jnp.asarray(a2)))
    got = th.merge(port_state(th, c1, a1),
                   TPeerModel(convert.params_from_jax(c2, th.layout),
                              t(a2)))
    np.testing.assert_allclose(views(th, got.params), np.asarray(want.params),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.n_updates.numpy(), np.maximum(a1, a2))


def test_merge_dispatch_unstacked_exact_stacked_greedy():
    """The JAX ``test_merge_dispatch_eager_exact_traced_greedy`` property:
    on the crafted geometry a merge of one unstacked pair averages the
    exact pairs, a merge of stacked rows the greedy ones, and each equals
    its JAX counterpart (eager, traced)."""
    jh = KMeansHandler(k=2, dim=1, matching="hungarian")
    th = TKMeansHandler(k=2, dim=1, matching="hungarian")
    c1 = np.array([[0.0], [10.0]], np.float32)
    c2 = np.array([[1.0], [-8.0]], np.float32)
    jst = JModelState(jnp.asarray(c1), (), jnp.int32(1))
    jpeer = JPeerModel(jnp.asarray(c2), jnp.int32(1))
    eager = np.asarray(jh.merge(jst, jpeer).params)
    traced = np.asarray(jax.jit(jh.merge)(jst, jpeer).params)
    one = th.merge(
        TModelState(convert.params_from_jax(c1, th.layout, stacked=False),
                    (), torch.tensor(1, dtype=torch.int32)),
        TPeerModel(convert.params_from_jax(c2, th.layout, stacked=False),
                   torch.tensor(1, dtype=torch.int32)))
    rows = th.merge(
        TModelState(convert.params_from_jax(c1[None], th.layout), (),
                    torch.ones(1, dtype=torch.int32)),
        TPeerModel(convert.params_from_jax(c2[None], th.layout),
                   torch.ones(1, dtype=torch.int32)))
    np.testing.assert_allclose(views(th, one.params).ravel(), [-4.0, 5.5])
    np.testing.assert_allclose(views(th, rows.params).ravel(), [0.5, 1.0])
    np.testing.assert_array_equal(views(th, one.params), eager)
    np.testing.assert_array_equal(views(th, rows.params)[0], traced)


def test_nmi_matches_jax():
    rng = np.random.default_rng(5)
    y = rng.integers(0, 3, (5, 40))
    p = rng.integers(0, 3, (5, 40))
    p[1] = y[1]                 # identical labellings: 1
    y[2] = 0
    p[2] = 0                    # both constant: 0
    mask = (rng.random((5, 40)) < 0.7).astype(np.float32)
    want = np.stack([np.asarray(nmi(jnp.asarray(y[i]), jnp.asarray(p[i]),
                                    3, 3, jnp.asarray(mask[i])))
                     for i in range(5)])
    got = tnmi(t(y), t(p), 3, 3, t(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[2] == 0.0


# -- matrix factorisation ---------------------------------------------------

ITEMS, DIM = 15, 3


def mf_pair():
    return (MFHandler(dim=DIM, n_items=ITEMS, lam_reg=0.1, learning_rate=0.05),
            TMFHandler(dim=DIM, n_items=ITEMS, lam_reg=0.1,
                       learning_rate=0.05))


def mf_params(jh, seed):
    return jax.vmap(jh.init)(jax.random.split(jax.random.PRNGKey(seed), N))


def ratings(seed=6):
    """Distinct items a node, ratings 1-5 with half stars; node 2 with
    masked slots inside, node 4 none."""
    rng = np.random.default_rng(seed)
    items = np.stack([rng.permutation(ITEMS)[:8] for _ in range(N)])
    r = (rng.integers(2, 11, (N, 8)) / 2.0).astype(np.float32)
    mask = np.ones((N, 8), np.float32)
    mask[2, [1, 4]] = 0.0
    mask[4] = 0.0
    return items.astype(np.int32), r, mask


def mf_port(th, jst):
    flat = convert.params_from_jax(jax.tree.map(np.asarray, jst.params),
                                   th.layout)
    return TModelState(flat, (), t(np.asarray(jst.n_updates)))


def assert_mf_close(th, got, want, atol):
    v = convert.params_to_numpy(got.params, th.layout)
    for k, leaf in convert.flatten_names(want.params).items():
        np.testing.assert_allclose(v[k], np.asarray(leaf), rtol=0, atol=atol,
                                   err_msg=k)
    np.testing.assert_array_equal(got.n_updates.numpy(),
                                  np.asarray(want.n_updates))


def test_mf_leaf_order_follows_jax_tree():
    jh, th = mf_pair()
    params = jh.init(jax.random.PRNGKey(0)).params
    leaves, treedef = jax.tree_util.tree_flatten(params)
    names = [jax.tree_util.keystr(p, simple=True, separator="/") for p, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    assert [name for name, _ in th.layout.leaves] == names == \
        ["X", "Y", "b", "c"]
    assert [shape for _, shape in th.layout.leaves] == \
        [tuple(a.shape) for a in leaves]
    assert th.get_size() == jh.get_size() == DIM * (ITEMS + 1)
    st = th.init(torch.Generator().manual_seed(0), "cpu")
    assert int(st.n_updates) == 1 == int(jh.init(jax.random.PRNGKey(0))
                                         .n_updates)
    v = convert.params_to_numpy(st.params, th.layout)
    assert v["b"] == 0.5 and (v["c"] == 0.5).all()


def test_mf_update_and_evaluate_match_jax():
    jh, th = mf_pair()
    items, r, mask = ratings()
    jst = mf_params(jh, 1)
    keys = jax.random.split(jax.random.PRNGKey(2), N)
    want = jax.vmap(jh.update)(jst, (items, r, mask), keys)
    got = th.update(mf_port(th, jst), t(items, r, mask))
    assert_mf_close(th, got, want, 1e-5)
    before = convert.params_to_numpy(mf_port(th, jst).params, th.layout)
    after = convert.params_to_numpy(got.params, th.layout)
    for k in before:
        np.testing.assert_array_equal(after[k][4], before[k][4], err_msg=k)
    mask[4, :3] = 1.0
    want_m = jax.vmap(jh.evaluate)(want, (items, r, mask))
    got_m = th.evaluate(got, t(items, r, mask))
    np.testing.assert_allclose(got_m["rmse"].numpy(),
                               np.asarray(want_m["rmse"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        trmse(t(r), t(r + 1.0), t(mask)).numpy(),
        np.asarray(jax.vmap(rmse)(r, r + 1.0, mask)), rtol=0, atol=1e-6)


def test_mf_merge_matches_jax():
    jh, th = mf_pair()
    a, b = mf_params(jh, 3), mf_params(jh, 4)
    a = a._replace(n_updates=jnp.asarray([1, 0, 5, 9, 2, 0], jnp.int32))
    b = b._replace(n_updates=jnp.asarray([3, 0, 5, 1, 7, 2], jnp.int32))
    want = jax.vmap(jh.merge)(a, JPeerModel(b.params, b.n_updates))
    pb = mf_port(th, b)
    got = th.merge(mf_port(th, a), TPeerModel(pb.params, pb.n_updates))
    assert_mf_close(th, got, want, 1e-6)
    # Only the item state moves; X and b stay the receiver's.
    va = convert.params_to_numpy(mf_port(th, a).params, th.layout)
    vg = convert.params_to_numpy(got.params, th.layout)
    np.testing.assert_array_equal(vg["X"], va["X"])
    np.testing.assert_array_equal(vg["b"], va["b"])
