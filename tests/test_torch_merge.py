"""The port's gather-merge against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions; they are
held against the JAX kernels (Pallas in interpret mode, as the JAX
package's own tests run them off-TPU: ``_multi_kernel`` K1,
``_multi_dq_kernel`` K2, ``_kernel`` K3, ``_dq_kernel`` K4) and against the
JAX plain versions. Tolerance ``atol = rtol = 1e-6``: both sides are fp32
and fold the slots in the same order. The CUDA kernels are held against
the same plain versions on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipy_tpu.ops.merge import (gather_merge_flat, gather_merge_multi,
                                   gather_merge_multi_pytree,
                                   gather_merge_multi_reference,
                                   gather_merge_pytree,
                                   gather_merge_reference)
from gossipy_tpu_torch import ops as tops
from gossipy_tpu_torch.ops import merge as tmerge

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-6)


def case(n, m, f, k, seed=0, poison=False):
    """Random operands; about a third of the slots empty. With ``poison``
    the ring rows that only empty slots point at hold NaN and Inf."""
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, f)).astype(np.float32)
    h = rng.normal(size=(m, f)).astype(np.float32)
    idx = rng.integers(0, m, (n, k)).astype(np.int32)
    wp = rng.uniform(size=(n, k)).astype(np.float32)
    empty = rng.uniform(size=(n, k)) < 0.34
    if poison:
        # Live slots read rows [0, m/2); empty slots point at the upper
        # half, which is not finite.
        idx = np.where(empty, rng.integers(m // 2, m, (n, k)),
                       rng.integers(0, m // 2, (n, k))).astype(np.int32)
        h[m // 2:] = np.nan
        h[m // 2::3] = np.inf
    wp = np.where(empty, 0.0, wp).astype(np.float32)
    ws = (1.0 - wp).astype(np.float32)
    return p, h, idx, ws, wp


def port(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("n,m,f,k", [
    (5, 10, 37, 1),      # K = 1, ragged F
    (5, 10, 37, 4),
    (6, 12, 1030, 4),    # F neither a multiple of 4 nor of 512
    (8, 16, 512, 4),
])
def test_plain_matches_jax_kernel_and_reference(n, m, f, k):
    p, h, idx, ws, wp = case(n, m, f, k)
    got = tops.gather_merge_multi(*port(p, h, idx, ws, wp)).numpy()
    want_kernel = np.asarray(gather_merge_multi(
        jnp.asarray(p), jnp.asarray(h), jnp.asarray(idx), jnp.asarray(ws),
        jnp.asarray(wp)))
    want_ref = np.asarray(gather_merge_multi_reference(
        jnp.asarray(p), jnp.asarray(h), jnp.asarray(idx), jnp.asarray(ws),
        jnp.asarray(wp)))
    np.testing.assert_allclose(got, want_kernel, **TOL)
    np.testing.assert_allclose(got, want_ref, **TOL)


@pytest.mark.parametrize("k", [1, 4])
def test_empty_slots_inert_to_nonfinite_rows(k):
    p, h, idx, ws, wp = case(6, 12, 130, k, seed=5, poison=True)
    assert (wp == 0).any()
    got = tops.gather_merge_multi(*port(p, h, idx, ws, wp)).numpy()
    assert np.isfinite(got).all()
    want = np.asarray(gather_merge_multi(
        jnp.asarray(p), jnp.asarray(h), jnp.asarray(idx), jnp.asarray(ws),
        jnp.asarray(wp)))
    np.testing.assert_allclose(got, want, **TOL)


def test_all_slots_empty_returns_p():
    p, h, idx, ws, wp = case(4, 8, 21, 4)
    wp[:] = 0.0
    ws[:] = 1.0
    got = tops.gather_merge_multi(*port(p, h, idx, ws, wp)).numpy()
    np.testing.assert_array_equal(got, p)


@pytest.mark.parametrize("k", [1, 4])
def test_pytree_form_matches_jax(k):
    rng = np.random.default_rng(7)
    n, d = 6, 2
    shapes = {"Conv_0/kernel": (3, 3, 3, 5), "Conv_0/bias": (5,),
              "Dense_0/kernel": (7, 3)}
    params = {k_: rng.normal(size=(n,) + s).astype(np.float32)
              for k_, s in shapes.items()}
    hist = {k_: rng.normal(size=(d, n) + s).astype(np.float32)
            for k_, s in shapes.items()}
    idx = rng.integers(0, d * n, (n, k)).astype(np.int32)
    wp = np.where(rng.uniform(size=(n, k)) < 0.3, 0.0,
                  0.5).astype(np.float32)
    ws = (1.0 - wp).astype(np.float32)
    got = tops.gather_merge_multi_pytree(
        {k_: torch.from_numpy(v) for k_, v in params.items()},
        {k_: torch.from_numpy(v) for k_, v in hist.items()},
        *port(idx, ws, wp))
    want = gather_merge_multi_pytree(
        {k_: jnp.asarray(v) for k_, v in params.items()},
        {k_: jnp.asarray(v) for k_, v in hist.items()},
        jnp.asarray(idx), jnp.asarray(ws), jnp.asarray(wp))
    for name in shapes:
        assert got[name].shape == params[name].shape
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   **TOL)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    tops.reset_launch_counts()
    tops.gather_merge_multi(*port(*case(4, 8, 21, 2)))
    assert tops.LAUNCHES["gather_merge_multi"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        tops.gather_merge_multi_cuda(*port(*case(4, 8, 21, 2)))


def test_rejects_mismatched_operands():
    p, h, idx, ws, wp = port(*case(4, 8, 21, 2))
    with pytest.raises(ValueError):
        tops.gather_merge_multi(p, h[:, :5], idx, ws, wp)
    with pytest.raises(ValueError):
        tops.gather_merge_multi(p, h, idx[:, 0], ws, wp)
    with pytest.raises(ValueError):
        tops.gather_merge_multi(p, h, idx, ws[:, :1], wp)


# -- wire-format rings (K2, K4) and the single-slot form (K3, K4) ----------
#
# The ring is bfloat16 or int8; int8 rows carry a float32 scale per ring
# row (the JAX single-array API, ``scale [M]``) or per ring row and leaf
# (the port's sidecar, ``scale [M, L]`` with ``leaf_starts``). Both sides
# widen, scale and blend in float32 in the same order, so the tolerance
# stays ``TOL``.

# Leaf widths 6, 12, 1, 7 and 24: edges at 6, 18, 19 and 26, three of them
# inside a 4-column word.
LEAF_SHAPES = {"A/bias": (6,), "A/kernel": (2, 3, 2), "B/bias": (1,),
               "B/kernel": (7,), "C/kernel": (4, 6)}


def wire_ring(h32, wire, seed=0):
    """``h32`` in a wire format, for JAX and for the port, and the int8
    ring's [M] scales (None for bfloat16)."""
    if wire == "bfloat16":
        return (jnp.asarray(h32).astype(jnp.bfloat16),
                torch.from_numpy(h32).to(torch.bfloat16), None)
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, h32.shape).astype(np.int8)
    scale = rng.uniform(0.001, 0.02, h32.shape[0]).astype(np.float32)
    return jnp.asarray(q), torch.from_numpy(q), scale


@pytest.mark.parametrize("wire", ["bfloat16", "int8"])
@pytest.mark.parametrize("n,m,f,k", [(5, 10, 37, 1), (6, 12, 1030, 4)])
def test_multi_dq_plain_matches_jax(wire, n, m, f, k):
    p, h, idx, ws, wp = case(n, m, f, k, seed=11)
    hj, ht, scale = wire_ring(h, wire)
    sj = None if scale is None else jnp.asarray(scale)
    st = None if scale is None else torch.from_numpy(scale)
    got = tops.gather_merge_multi(*port(p), ht, *port(idx, ws, wp),
                                  scale=st).numpy()
    args = (jnp.asarray(p), hj, jnp.asarray(idx), jnp.asarray(ws),
            jnp.asarray(wp))
    np.testing.assert_allclose(
        got, np.asarray(gather_merge_multi(*args, scale=sj)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(gather_merge_multi_reference(*args, scale=sj)),
        **TOL)


@pytest.mark.parametrize("wire", ["bfloat16", "int8"])
def test_multi_dq_empty_slots_inert(wire):
    """Ring rows (bfloat16) or scales (int8) behind empty slots are NaN or
    Inf; the result stays finite and equal to the JAX kernel's."""
    p, h, idx, ws, wp = case(6, 12, 130, 4, seed=5, poison=True)
    hj, ht, scale = wire_ring(h, wire, seed=5)
    if scale is not None:
        scale[6:] = np.nan
        scale[6::3] = np.inf
    sj = None if scale is None else jnp.asarray(scale)
    st = None if scale is None else torch.from_numpy(scale)
    got = tops.gather_merge_multi(*port(p), ht, *port(idx, ws, wp),
                                  scale=st).numpy()
    assert np.isfinite(got).all()
    want = gather_merge_multi(jnp.asarray(p), hj, jnp.asarray(idx),
                              jnp.asarray(ws), jnp.asarray(wp), scale=sj)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("n,m,f", [(5, 10, 37), (6, 12, 1030)])
def test_flat_plain_matches_jax(wire, n, m, f):
    p, h, idx, ws, wp = case(n, m, f, 1, seed=13)
    idx, ws, wp = idx[:, 0], ws[:, 0], wp[:, 0]
    if wire == "float32":
        hj, ht, scale = jnp.asarray(h), torch.from_numpy(h), None
    else:
        hj, ht, scale = wire_ring(h, wire)
    sj = None if scale is None else jnp.asarray(scale)
    st = None if scale is None else torch.from_numpy(scale)
    got = tops.gather_merge_flat(*port(p), ht, *port(idx, ws, wp),
                                 scale=st).numpy()
    args = (jnp.asarray(p), hj, jnp.asarray(idx), jnp.asarray(ws),
            jnp.asarray(wp))
    np.testing.assert_allclose(
        got, np.asarray(gather_merge_flat(*args, scale=sj)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(gather_merge_reference(*args, scale=sj)), **TOL)


def test_flat_has_no_zero_weight_mask():
    """As the JAX kernel: a receiver with w_peer = 0 still reads its row,
    so a non-finite row reaches it (the engine discards such rows)."""
    p, h, idx, ws, wp = case(4, 8, 21, 1, seed=2)
    idx, ws, wp = idx[:, 0], ws[:, 0], wp[:, 0]
    wp[0], ws[0] = 0.0, 1.0
    h[idx[0]] = np.nan
    got = tops.gather_merge_flat(*port(p, h, idx, ws, wp)).numpy()
    assert np.isnan(got[0]).all()


def leaf_case(k, seed):
    """A stacked multi-leaf tree of params, a [D, N] ring per leaf in
    int8 with [D, N] scales per leaf, and [N, K] tables."""
    rng = np.random.default_rng(seed)
    n, d = 6, 2
    params = {k_: rng.normal(size=(n,) + s).astype(np.float32)
              for k_, s in LEAF_SHAPES.items()}
    hist = {k_: rng.integers(-127, 128, (d, n) + s).astype(np.int8)
            for k_, s in LEAF_SHAPES.items()}
    scales = {k_: rng.uniform(0.001, 0.02, (d, n)).astype(np.float32)
              for k_ in LEAF_SHAPES}
    idx = rng.integers(0, d * n, (n, k)).astype(np.int32)
    wp = np.where(rng.uniform(size=(n, k)) < 0.3, 0.0,
                  0.5).astype(np.float32)
    return params, hist, scales, idx, (1.0 - wp).astype(np.float32), wp


def as_torch(tree):
    return {k_: torch.from_numpy(v) for k_, v in tree.items()}


def as_jax(tree):
    return {k_: jnp.asarray(v) for k_, v in tree.items()}


@pytest.mark.parametrize("k", [1, 4])
def test_multi_dq_pytree_per_leaf_scales_match_jax(k):
    """One launch over the concatenated row with a per-(row, leaf) scale
    table, against the JAX pytree form (leaves padded to 512 there)."""
    params, hist, scales, idx, ws, wp = leaf_case(k, seed=17)
    got = tops.gather_merge_multi_pytree(
        as_torch(params), as_torch(hist), *port(idx, ws, wp),
        scales=as_torch(scales))
    want = gather_merge_multi_pytree(
        as_jax(params), as_jax(hist), jnp.asarray(idx), jnp.asarray(ws),
        jnp.asarray(wp), scales=as_jax(scales))
    for name in LEAF_SHAPES:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   **TOL, err_msg=name)


def test_flat_pytree_per_leaf_scales_match_jax():
    params, hist, scales, idx, ws, wp = leaf_case(1, seed=19)
    idx, ws, wp = idx[:, 0], ws[:, 0], wp[:, 0]
    got = tops.gather_merge_pytree(as_torch(params), as_torch(hist),
                                   *port(idx, ws, wp),
                                   scales=as_torch(scales))
    want = gather_merge_pytree(as_jax(params), as_jax(hist),
                               jnp.asarray(idx), jnp.asarray(ws),
                               jnp.asarray(wp), scales=as_jax(scales))
    for name in LEAF_SHAPES:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   **TOL, err_msg=name)


def test_column_leaves_split_words():
    starts = [0, 6, 18, 19, 26]
    got = tops.column_leaves(starts, 52, "cpu").tolist()
    want = [0] * 6 + [1] * 12 + [2] + [3] * 7 + [4] * 26
    assert got == want


def test_new_kernels_count_nothing_on_cpu_and_need_cuda():
    tops.reset_launch_counts()
    p, h, idx, ws, wp = port(*case(4, 8, 21, 2))
    hq = h.to(torch.int8)
    scale = torch.ones(8)
    tops.gather_merge_multi(p, hq, idx, ws, wp, scale=scale)
    tops.gather_merge_flat(p, h, idx[:, 0], ws[:, 0], wp[:, 0])
    tops.gather_merge_flat(p, hq, idx[:, 0], ws[:, 0], wp[:, 0], scale=scale)
    assert sum(tops.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="CUDA"):
        tops.gather_merge_multi_dq_cuda(p, hq, idx, ws, wp, scale=scale)
    with pytest.raises(ValueError, match="CUDA"):
        tops.gather_merge_flat_cuda(p, h, idx[:, 0], ws[:, 0], wp[:, 0])


def test_dq_kernels_take_no_unscaled_float32_or_int8_ring():
    # K2/K4 take a bfloat16 ring bare and any ring with a scale; the
    # float32 ring with no scale is K1's/K3's, and int8 always has one.
    h = torch.zeros(4, 8)
    for dtype in (torch.float32, torch.int8):
        with pytest.raises(TypeError, match="needs a scale"):
            tmerge._check_wire_scale("k", h.to(dtype), None)
    tmerge._check_wire_scale("k", h.to(torch.bfloat16), None)
    tmerge._check_wire_scale("k", h.to(torch.int8), torch.ones(4))


def test_rejects_bad_scale_tables():
    p, h, idx, ws, wp = port(*case(4, 8, 21, 2))
    with pytest.raises(ValueError):  # not one scale per ring row
        tops.gather_merge_multi(p, h, idx, ws, wp, scale=torch.ones(7))
    with pytest.raises(ValueError):  # several leaves, no starts
        tops.gather_merge_multi(p, h, idx, ws, wp, scale=torch.ones(8, 2))
    with pytest.raises(ValueError):  # starts not from column 0
        tops.gather_merge_flat(p, h, idx[:, 0], ws[:, 0], wp[:, 0],
                               scale=torch.ones(8, 2), leaf_starts=[1, 5])
    with pytest.raises(ValueError):  # idx must be [N] for the flat form
        tops.gather_merge_flat(p, h, idx, ws, wp)
