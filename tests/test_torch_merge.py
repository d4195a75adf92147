"""The port's multi-slot gather-merge against the JAX package's.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
against the JAX kernel ``_multi_kernel`` (Pallas in interpret mode, as the
JAX package's own tests run it off-TPU) and against the JAX plain version
``gather_merge_multi_reference``. Tolerance ``atol = rtol = 1e-6``: both
sides are fp32 and fold the slots in the same order. The CUDA kernel is
held against the same plain version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipy_tpu.ops.merge import (gather_merge_multi,
                                   gather_merge_multi_pytree,
                                   gather_merge_multi_reference)
from gossipy_tpu_torch import ops as tops

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
