"""The port's ring collectives (``gossipy_tpu_torch/parallel/collectives.py``)
against dense results and against the JAX package's rings.

The port runs a ring over a virtual mesh: positions that all name the
CPU (``make_mesh(8, devices=["cpu"] * 8)``), the counterpart of the JAX
package's conftest mesh of 8 virtual CPU devices. Each test of
``tests/test_collectives.py`` has a counterpart here, except three,
which have none because the port compiles nothing: ``test_ring_matmul_
rolled_loop`` and ``TestRingAttention.test_rolled_loop`` (the port has no
``_UNROLL_MAX``/``fori_loop`` branch: every ring runs its hops in a Python
loop) and the two ``test_under_jit`` cases (there is no jit to run
under). The cross-package tests hold the port on 8 positions against the
JAX package on its 8 devices from the same numpy inputs:
``ring_all_gather`` exactly, ``ring_mixed_matmul`` and
``ring_mix_pytree`` within 1e-5, ``sharded_gather_merge_multi`` within
1e-6 (float32 and int8 rings), ``ring_attention`` and its gradients
within the port's flash-attention tolerance against JAX (1e-5, as
``test_torch_attention.py``; the gradients on 4 positions and 4 devices).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipy_tpu.parallel import make_mesh as jmake_mesh
from gossipy_tpu.parallel import collectives as jcoll
from gossipy_tpu_torch import core as tcore
from gossipy_tpu_torch import parallel
from gossipy_tpu_torch.handlers import WeightedSGDHandler, losses
from gossipy_tpu_torch.models import LogisticRegression
from gossipy_tpu_torch.ops import merge as tmerge
from gossipy_tpu_torch.parallel.collectives import (
    _axis_size, _ring_perm, ring_all_gather, ring_attention, ring_mix_pytree,
    ring_mixed_matmul, sharded_gather_merge_multi)
from gossipy_tpu_torch.random import TorchDraws
from gossipy_tpu_torch.simulation import All2AllGossipSimulator

ATOL = 1e-5


@pytest.fixture(scope="module")
def mesh():
    return parallel.make_mesh(8, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def mesh4():
    return parallel.make_mesh(4, devices=["cpu"] * 4)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the schedule ---------------------------------------------------------------

def test_ring_perm_and_axis_size_match_jax():
    for d in (1, 2, 5, 8):
        assert _ring_perm(d) == jcoll._ring_perm(d)
    m2 = parallel.make_mesh_2d(2, 4, devices=["cpu"] * 8)
    assert _axis_size(m2, ("dcn", "nodes")) == 8
    assert _axis_size(m2, "nodes") == 4


# -- counterparts of tests/test_collectives.py ---------------------------------

def test_ring_all_gather_matches_identity(mesh):
    x = torch.arange(16 * 5, dtype=torch.float32).reshape(16, 5)
    assert torch.equal(ring_all_gather(x, mesh), x)


def test_ring_matmul_matches_dense(mesh):
    rng = np.random.default_rng(0)
    n, f = 24, 17
    w = t(rng.normal(size=(n, n)).astype(np.float32))
    x = t(rng.normal(size=(n, f)).astype(np.float32))
    np.testing.assert_allclose(ring_mixed_matmul(w, x, mesh).numpy(),
                               (w @ x).numpy(), rtol=1e-5, atol=1e-5)


def test_ring_matmul_2d_mesh():
    """On a 2-D (dcn, nodes) mesh the ring runs over the combined axes:
    every position holds N/8 rows, not N/4."""
    mesh2 = parallel.make_mesh_2d(2, 4, devices=["cpu"] * 8)
    rng = np.random.default_rng(4)
    n, f = 16, 9
    w = t(rng.normal(size=(n, n)).astype(np.float32))
    x = t(rng.normal(size=(n, f)).astype(np.float32))
    got = ring_mixed_matmul(w, x, mesh2, ("dcn", "nodes"))
    np.testing.assert_allclose(got.numpy(), (w @ x).numpy(), rtol=1e-5,
                               atol=1e-5)


def test_ring_matmul_custom_axis_name():
    """A 1-D mesh with another axis name works end to end (the node axis
    entry derives from the mesh)."""
    m = parallel.make_mesh(8, axis_name="x", devices=["cpu"] * 8)
    rng = np.random.default_rng(6)
    w = t(rng.normal(size=(8, 8)).astype(np.float32))
    x = t(rng.normal(size=(8, 5)).astype(np.float32))
    np.testing.assert_allclose(ring_mixed_matmul(w, x, m, "x").numpy(),
                               (w @ x).numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ring_mixed_matmul(w, x, m).numpy(),
                               (w @ x).numpy(), rtol=1e-5, atol=1e-5)


def test_ring_mix_pytree(mesh):
    rng = np.random.default_rng(2)
    n = 16
    w = t(rng.normal(size=(n, n)).astype(np.float32))
    tree = {"a": t(rng.normal(size=(n, 3, 4)).astype(np.float32)),
            "b": t(rng.normal(size=(n,)).astype(np.float32))}
    got = ring_mix_pytree(w, tree, mesh)
    np.testing.assert_allclose(
        got["a"].numpy(), (w @ tree["a"].reshape(n, -1)).reshape(n, 3, 4)
        .numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["b"].numpy(),
                               (w @ tree["b"][:, None])[:, 0].numpy(),
                               rtol=1e-5, atol=1e-5)
    flat = t(rng.normal(size=(n, 7)).astype(np.float32))
    np.testing.assert_allclose(ring_mix_pytree(w, flat, mesh).numpy(),
                               (w @ flat).numpy(), rtol=1e-5, atol=1e-5)


def _all2all(ring: bool, mesh, history_dtype="float32"):
    from gossipy_tpu_torch.data import ClassificationDataHandler, \
        DataDispatcher
    n, d = 16, 8
    rng = np.random.default_rng(3)
    wvec = rng.normal(size=d)
    X = rng.normal(size=(n * 20, d)).astype(np.float32)
    y = (X @ wvec > 0).astype(np.int64)
    disp = DataDispatcher(ClassificationDataHandler(X, y, test_size=0.25),
                          n=n)
    topo = tcore.Topology.random_regular(n, 4, seed=0)
    handler = WeightedSGDHandler(
        LogisticRegression(d, 2), losses.cross_entropy, learning_rate=0.1,
        local_epochs=1, batch_size=8, n_classes=2, input_shape=(d,),
        create_model_mode=tcore.CreateModelMode.MERGE_UPDATE)
    data = parallel.shard_data(disp.stacked(), mesh)
    return All2AllGossipSimulator(handler, topo, data, delta=4,
                                  mixing=tcore.uniform_mixing(topo),
                                  mesh=mesh, ring_mix=ring,
                                  history_dtype=history_dtype,
                                  draws=TorchDraws(9), device="cpu")


@pytest.mark.parametrize("history_dtype", ["float32", "bfloat16"])
def test_all2all_ring_equals_dense(mesh, history_dtype):
    """The ring-scheduled mixing gives the same simulation as the dense
    product (same draws; only the product's schedule differs), on an fp32
    wire (one product) and a bf16 wire (the exact diagonal plus the
    off-diagonal product over the wire's round trip)."""
    results = []
    for ring in (False, True):
        sim = _all2all(ring, mesh, history_dtype)
        state = parallel.shard_state(
            sim.init_nodes(torch.Generator().manual_seed(7)), mesh)
        state, report = sim.start(state, n_rounds=3)
        results.append((state, report.curves(local=False)["accuracy"][-1]))
    (s_dense, acc_dense), (s_ring, acc_ring) = results
    np.testing.assert_allclose(s_ring.model.params.numpy(),
                               s_dense.model.params.numpy(), atol=1e-4)
    assert abs(acc_dense - acc_ring) < 1e-5


def dense_attention(q, k, v, causal=False):
    s = (q @ k.T) / np.sqrt(q.shape[1])
    if causal:
        pos = np.arange(q.shape[0])
        s = np.where(pos[None, :] > pos[:, None], -1e30, s)
    p = np.exp(s - s.max(axis=1, keepdims=True))
    p = p / p.sum(axis=1, keepdims=True)
    return p @ v


class TestRingAttention:
    """Sequence-parallel attention over the ring: K5's plain version on
    every hop of a CPU ring with ``flash=True``, the plain hop body with
    the default."""

    @pytest.mark.parametrize("flash", [None, True])
    def test_matches_dense(self, mesh4, flash):
        rng = np.random.default_rng(0)
        s_len, d, dv = 32, 16, 12
        q = rng.normal(size=(s_len, d)).astype(np.float32)
        k = rng.normal(size=(s_len, d)).astype(np.float32)
        v = rng.normal(size=(s_len, dv)).astype(np.float32)
        got = ring_attention(t(q), t(k), t(v), mesh4, flash=flash)
        np.testing.assert_allclose(got.numpy(), dense_attention(q, k, v),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("flash", [None, True])
    def test_causal_masks_by_global_position(self, mesh4, flash):
        rng = np.random.default_rng(1)
        s_len, d = 24, 8
        q, k, v = (rng.normal(size=(s_len, d)).astype(np.float32)
                   for _ in range(3))
        got = ring_attention(t(q), t(k), t(v), mesh4, causal=True,
                             flash=flash).numpy()
        np.testing.assert_allclose(got, dense_attention(q, k, v, True),
                                   rtol=1e-5, atol=1e-5)
        # Row 0 may only attend to position 0: its output is v[0].
        np.testing.assert_allclose(got[0], v[0], rtol=1e-5, atol=1e-5)

    def test_vmapped_over_heads(self, mesh4):
        """A leading head axis: one ring a head (the JAX users' vmap)."""
        rng = np.random.default_rng(2)
        h, s_len, d = 3, 16, 8
        q, k, v = (rng.normal(size=(h, s_len, d)).astype(np.float32)
                   for _ in range(3))
        got = ring_attention(t(q), t(k), t(v), mesh4, flash=True)
        want = np.stack([dense_attention(q[i], k[i], v[i]) for i in range(h)])
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("causal", [False, True])
    def test_gradients_match_dense(self, mesh4, causal):
        """Gradients of a scalar loss through the ring (the hop's
        hand-derived backward on every hop) equal those through dense
        attention, for q, k and v."""
        rng = np.random.default_rng(7)
        s_len, dim = 16, 8
        arrays = [rng.normal(size=(s_len, dim)).astype(np.float32)
                  for _ in range(4)]
        tgt = t(arrays[3])

        def grads(fn):
            q, k, v = (t(a).requires_grad_(True) for a in arrays[:3])
            loss = torch.mean((fn(q, k, v) - tgt) ** 2)
            return torch.autograd.grad(loss, [q, k, v])

        def dense(q, k, v):
            s = (q @ k.T) / np.sqrt(dim)
            if causal:
                mask = torch.triu(torch.ones(s_len, s_len, dtype=torch.bool),
                                  1)
                s = s.masked_fill(mask, -1e30)
            return torch.softmax(s, dim=1) @ v

        want = grads(dense)
        for flash in (None, True):
            got = grads(lambda q, k, v: ring_attention(
                q, k, v, mesh4, causal=causal, flash=flash))
            for g, w, name in zip(got, want, "qkv"):
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                           atol=1e-5,
                                           err_msg=f"d{name} flash={flash}")

    def test_trains_a_tiny_attention_model(self, mesh4):
        """One attention layer trained with the sequence on the ring: the
        loss must drop on a retrieval task."""
        from gossipy_tpu_torch.optim import adam, apply_updates
        rng = np.random.default_rng(11)
        s_len, dim = 16, 8
        x = t(rng.normal(size=(s_len, dim)).astype(np.float32))
        tgt = x[0].expand(s_len, dim)
        params = {k: torch.eye(dim) for k in ("wq", "wk", "wv")}
        opt = adam(0.05)
        state = opt.init(params)
        out = []
        for _ in range(25):
            leaves = {k: p.detach().requires_grad_(True)
                      for k, p in params.items()}
            loss = torch.mean((ring_attention(
                x @ leaves["wq"], x @ leaves["wk"], x @ leaves["wv"],
                mesh4, flash=True) - tgt) ** 2)
            g = torch.autograd.grad(loss, list(leaves.values()))
            updates, state = opt.update(dict(zip(leaves, g)), state)
            params = apply_updates(params, updates)
            out.append(float(loss.detach()))
        assert np.isfinite(out).all()
        assert out[-1] < 0.5 * out[0], out[::6]

    def test_plain_body_refused_on_cuda_positions(self):
        """On a CUDA mesh every hop runs K5: the plain body is refused
        there (checked without a card: the refusal comes before any
        tensor moves)."""
        fake = parallel.make_mesh(devices=[parallel.Position(
            torch.device("cuda", 0), 0, i) for i in range(2)])
        q = torch.zeros(4, 2)
        with pytest.raises(ValueError, match="K5"):
            ring_attention(q, q, q, fake, flash=False)


# -- the JAX package's rings, from the same inputs ---------------------------------

@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    return jmake_mesh(8)


def test_ring_all_gather_equals_jax(mesh, jmesh):
    x = np.random.default_rng(20).normal(size=(24, 3, 2)).astype(np.float32)
    want = np.asarray(jcoll.ring_all_gather(jnp.asarray(x), jmesh))
    got = ring_all_gather(t(x), mesh).numpy()
    np.testing.assert_array_equal(got, want)


def test_ring_mixed_matmul_and_pytree_match_jax(mesh, jmesh):
    rng = np.random.default_rng(21)
    n = 16
    w = rng.normal(size=(n, n)).astype(np.float32)
    x = rng.normal(size=(n, 11)).astype(np.float32)
    np.testing.assert_allclose(
        ring_mixed_matmul(t(w), t(x), mesh).numpy(),
        np.asarray(jcoll.ring_mixed_matmul(jnp.asarray(w), jnp.asarray(x),
                                           jmesh)), rtol=0, atol=1e-5)
    tree = {"k": rng.normal(size=(n, 3, 4)).astype(np.float32),
            "b": rng.normal(size=(n, 4)).astype(np.float32)}
    got = ring_mix_pytree(t(w), {k: t(v) for k, v in tree.items()}, mesh)
    want = jcoll.ring_mix_pytree(jnp.asarray(w),
                                 {k: jnp.asarray(v) for k, v in tree.items()},
                                 jmesh)
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


def merge_inputs(seed, n=16, depth=3, k=4, widths=(6, 4, 3)):
    """Per-leaf params ``[N, w]``, a ``[D, N, w]`` ring, ``[N, K]`` slot
    tables (global indices, about half the slots live, ws = 1 - wp on
    live slots and (1, 0) on empty ones)."""
    rng = np.random.default_rng(seed)
    names = [f"l{i}" for i in range(len(widths))]
    params = {nm: rng.normal(size=(n, w)).astype(np.float32)
              for nm, w in zip(names, widths)}
    hist = {nm: rng.normal(size=(depth, n, w)).astype(np.float32)
            for nm, w in zip(names, widths)}
    idx = rng.integers(0, depth * n, size=(n, k)).astype(np.int64)
    live = rng.random((n, k)) < 0.6
    wp = np.where(live, rng.uniform(0.2, 0.7, size=(n, k)), 0.0).astype(
        np.float32)
    ws = np.where(live, 1.0 - wp, 1.0).astype(np.float32)
    return params, hist, idx, ws, wp


@pytest.mark.parametrize("wire", ["float32", "int8"])
def test_sharded_gather_merge_multi_matches_jax(mesh, jmesh, wire):
    """The composed linear form on 8 positions against the JAX ring on 8
    devices (1e-6), and against the port's own unsharded K1 fold (the
    bit-compatibility reference, reassociation apart)."""
    params, hist, idx, ws, wp = merge_inputs(30)
    scales = None
    if wire == "int8":
        rng = np.random.default_rng(31)
        hist = {k: rng.integers(-127, 128, size=v.shape).astype(np.int8)
                for k, v in hist.items()}
        scales = {k: rng.uniform(0.001, 0.02, size=v.shape[:2]).astype(
            np.float32) for k, v in hist.items()}
    jargs = [jax.tree.map(jnp.asarray, a) for a in (params, hist)]
    want = jcoll.sharded_gather_merge_multi(
        jargs[0], jargs[1], jnp.asarray(idx.astype(np.int32)),
        jnp.asarray(ws), jnp.asarray(wp), jmesh,
        scales=None if scales is None else jax.tree.map(jnp.asarray, scales))
    tw = lambda d: {k: t(v) for k, v in d.items()}  # noqa: E731
    got = sharded_gather_merge_multi(
        tw(params), tw(hist), t(idx), t(ws), t(wp), mesh,
        scales=None if scales is None else tw(scales))
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    flat = tmerge.gather_merge_multi_pytree(
        tw(params), tw(hist), t(idx), t(ws), t(wp),
        None if scales is None else tw(scales))
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), flat[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_sharded_merge_flat_rows_equal_dict_form(mesh):
    """The engine's form (one ``[N, F]`` row, a ``[D, N, L]`` scale table
    with leaf starts) equals the dict form bit for bit."""
    params, hist, idx, ws, wp = merge_inputs(32)
    rng = np.random.default_rng(33)
    hist = {k: rng.integers(-127, 128, size=v.shape).astype(np.int8)
            for k, v in hist.items()}
    scales = {k: rng.uniform(0.001, 0.02, size=v.shape[:2]).astype(
        np.float32) for k, v in hist.items()}
    keys = sorted(params)
    p = t(np.concatenate([params[k] for k in keys], axis=1))
    h = t(np.concatenate([hist[k] for k in keys], axis=2))
    sc = t(np.stack([scales[k] for k in keys], axis=2))
    starts = np.cumsum([0] + [params[k].shape[1] for k in keys[:-1]]).tolist()
    flat = sharded_gather_merge_multi(p, h, t(idx), t(ws), t(wp), mesh,
                                      scales=sc, leaf_starts=starts)
    tw = lambda d: {k: t(v) for k, v in d.items()}  # noqa: E731
    tree = sharded_gather_merge_multi(tw(params), tw(hist), t(idx), t(ws),
                                      t(wp), mesh, scales=tw(scales))
    assert torch.equal(flat, torch.cat([tree[k] for k in keys], dim=1))


def test_sharded_merge_launches_per_hop(mesh4, monkeypatch):
    """One merge call a position a hop: d² calls on a ring of d, each at
    ``n = N/d`` rows against a ``[D·N/d, F]`` chunk, with an int64 table."""
    calls = []
    real = tmerge.gather_merge_multi

    def counted(p, h, idx, ws, wp, *rest):
        calls.append((tuple(p.shape), tuple(h.shape), idx.dtype))
        return real(p, h, idx, ws, wp, *rest)

    monkeypatch.setattr(tmerge, "gather_merge_multi", counted)
    params, hist, idx, ws, wp = merge_inputs(34, widths=(5,))
    sharded_gather_merge_multi(t(params["l0"]), t(hist["l0"]), t(idx),
                               t(ws), t(wp), mesh4)
    assert len(calls) == 16
    assert set(calls) == {((4, 5), (12, 5), torch.int64)}


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(mesh, jmesh, causal):
    """Forward on 8 positions against the JAX ring on 8 devices (its jnp
    hop body off the TPU), with the port's plain body and with K5's plain
    version on every hop."""
    rng = np.random.default_rng(40)
    s_len, d, dv = 64, 16, 12
    q, k = (rng.normal(size=(s_len, d)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(s_len, dv)).astype(np.float32)
    want = np.asarray(jcoll.ring_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), jmesh,
                                           causal=causal))
    for flash in (None, True):
        got = ring_attention(t(q), t(k), t(v), mesh, causal=causal,
                             flash=flash).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL,
                                   err_msg=f"flash={flash}")


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_gradients_match_jax(mesh4, causal):
    """Gradients of one loss through both rings, for q, k and v, on 4
    positions and 4 devices (the JAX package's own gradient test takes
    its 4-device submesh: the shard_map gradient's compile grows with the
    ring)."""
    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 devices")
    jmesh4 = jmake_mesh(4)
    rng = np.random.default_rng(41)
    s_len, d = 32, 8
    q, k, v, tgt = (rng.normal(size=(s_len, d)).astype(np.float32)
                    for _ in range(4))

    def jloss(q, k, v):
        out = jcoll.ring_attention(q, k, v, jmesh4, causal=causal)
        return jnp.mean((out - tgt) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v))
    for flash in (None, True):
        leaves = [t(a).requires_grad_(True) for a in (q, k, v)]
        out = ring_attention(*leaves, mesh4, causal=causal, flash=flash)
        got = torch.autograd.grad(torch.mean((out - t(tgt)) ** 2), leaves)
        for g, w, name in zip(got, want, "qkv"):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=ATOL,
                                       err_msg=f"d{name} flash={flash}")
