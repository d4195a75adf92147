"""K1/K2's launch plan and plain versions at the shapes of the row layout.

``launch_plan`` is the pure Python function that maps a call onto the
card: a group of G lanes a row for rows of up to 32 words, a block per
(row, tile) for wider rows and for the slot walk (the wide rows with a
scale table, and narrow calls of few rows with many slots). The CUDA
kernels follow the mapping that
``cells`` below spells out; here every shape of ``chip_smoke.py``'s
sweep (the 100,000-row ladder included) is held to cover every row and
word exactly once within the card's grid limits.

The plain versions of K1 and K2 (bf16, int8) are held against the JAX
kernels in Pallas interpret mode at the sweep's route edges, with an
int64 index table, NaN and Inf behind empty slots, empty slots whose
w_self is not 1, and -0.0 in ``p``: values within ``atol = rtol = 1e-6``
(the JAX kernel's XLA program may round a multiply-add once), zeros at
the same places with the same signs. The kernels are held bit for bit to
these plain versions on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipy_tpu.ops.merge import gather_merge_multi
from gossipy_tpu_torch.ops import merge as tmerge

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-6)
CIFAR_STRIDE = 73420  # CIFAR10Net's flat row (the flagship, phase 3)

# (n, f, k, ring dtype): the sweep's shapes.
SWEEP = [(50_000, 116, 6, torch.float32),      # scale row
         (50_000, 116, 6, torch.bfloat16),
         (100_000, 116, 6, torch.float32),     # ladder rung
         (4141, 60, 59, torch.float32),        # Giaretta
         (4141, 60, 59, torch.bfloat16),
         (4141, 60, 8, torch.float32),         # Ormandi
         (100, 116, 6, torch.float32),         # north star
         (100, 116, 6, torch.int8),
         (100, CIFAR_STRIDE, 6, torch.float32),   # flagship
         (100, CIFAR_STRIDE, 6, torch.int8),
         (64, CIFAR_STRIDE, 4, torch.bfloat16),   # phase 3
         (64, CIFAR_STRIDE - 2, 4, torch.float32)]
EDGE_F = (1, 3, 4, 60, 116, 128, 132)
EDGE_K = (1, 59, 64)
EDGE_N = 37


def cells(plan, n):
    """The ``(row, word)`` each lane of the plan's grid takes, as the
    kernel maps them (``[grid_x, grid_y, threads, words_per_lane]``
    arrays): narrow, lane t of block x takes row x * rows_per_block + t //
    group and word t % group; wide or the slot walk, lane t of block (x,
    y) takes row x and words y * threads * words_per_lane + i * threads +
    t."""
    bx = torch.arange(plan.grid[0])[:, None, None, None]
    by = torch.arange(plan.grid[1])[None, :, None, None]
    t = torch.arange(plan.threads)[None, None, :, None]
    i = torch.arange(plan.words_per_lane)[None, None, None, :]
    shape = (plan.grid[0], plan.grid[1], plan.threads, plan.words_per_lane)
    if plan.wide or plan.slots:
        row = bx.expand(shape)
        word = (by * plan.threads * plan.words_per_lane + i * plan.threads
                + t).expand(shape)
    else:
        row = (bx * plan.rows_per_block + t // plan.group).expand(shape)
        word = (t % plan.group + i * plan.threads).expand(shape)
    return row, word


def check_plan(n, f, k, dtype, aligned=True, scaled=False):
    plan = tmerge.launch_plan(n, f, k, dtype, aligned, scaled)
    scaled = scaled or dtype == torch.int8
    assert plan.vec == (aligned and f % 4 == 0)
    assert plan.words == (f // 4 if plan.vec else f)
    assert plan.wide == (plan.words > tmerge.WARP)
    assert plan.group in (1, 2, 4, 8, 16, 32)
    assert k <= tmerge.TABLE_REGS * plan.group
    slots = (plan.wide and scaled) or (k > 8 and n < tmerge.SMS)
    assert plan.slots == slots
    assert (plan.words_per_lane, plan.in_flight) == (
        (1, 1) if slots else (1, 8) if k > 8
        else (tmerge.WIDE_WORDS, 2) if plan.wide else (1, 4))
    assert plan.threads % tmerge.WARP == 0
    assert plan.threads <= tmerge.BLOCK
    assert plan.threads == plan.rows_per_block * plan.group \
        or ((plan.wide or slots) and plan.rows_per_block == 1)
    assert plan.grid[0] <= tmerge.MAX_GRID_X
    assert plan.grid[1] <= tmerge.MAX_GRID_Y
    if not plan.wide:
        assert plan.words <= plan.threads and plan.grid[1] == 1
    if not (plan.wide or slots):
        assert plan.words <= plan.group
        assert plan.rows_per_block == tmerge.BLOCK // plan.group
    row, word = cells(plan, n)
    on = (row < n) & (word < plan.words)
    flat = (row[on] * plan.words + word[on]).flatten()
    counts = torch.bincount(flat, minlength=n * plan.words)
    assert counts.numel() == n * plan.words
    assert bool((counts == 1).all())
    # No block is wholly idle: the grid is no larger than it must be.
    busy = on.reshape(plan.grid[0] * plan.grid[1], -1).any(dim=1)
    assert bool(busy.all())
    return plan


@pytest.mark.parametrize("n,f,k,dtype", SWEEP)
def test_plan_covers_every_row_and_word_once(n, f, k, dtype):
    plan = check_plan(n, f, k, dtype)
    if f in (116, 60):  # the narrow route: lanes for the words and slots
        assert not plan.wide
        assert plan.group == max(tmerge._pow2_at_least(plan.words),
                                 tmerge._pow2_at_least(-(-k // 2)))
        assert not plan.slots
        assert plan.rows_per_block == tmerge.BLOCK // plan.group
        if k <= 8:  # nearly every lane carries a word
            assert plan.words / plan.group > 0.9
    if f >= CIFAR_STRIDE - 2:
        assert plan.wide and plan.threads == tmerge.BLOCK


@pytest.mark.parametrize("f", EDGE_F)
@pytest.mark.parametrize("k", EDGE_K)
def test_plan_covers_route_edges(f, k):
    for dtype in (torch.float32, torch.int8):
        check_plan(EDGE_N, f, k, dtype)
        check_plan(EDGE_N, f, k, dtype, aligned=False)
    check_plan(EDGE_N, f, k, torch.bfloat16, scaled=True)
    plan = tmerge.launch_plan(EDGE_N, f, k)
    assert plan.wide == (f == 132)
    # 37 rows with many slots: the slot walk, a warp a narrow row
    assert plan.slots == (k > 8)
    if plan.slots and not plan.wide:
        assert plan.threads == tmerge.WARP
    scaled = tmerge.launch_plan(EDGE_N, f, k, torch.int8)
    assert scaled.slots == (plan.slots or plan.wide)
    if scaled.slots:  # 256 lanes stage the K x L scales
        assert scaled.threads == tmerge.BLOCK
    if not (plan.wide or plan.slots):
        assert EDGE_N % plan.rows_per_block != 0


def test_plan_raises_past_its_limits():
    with pytest.raises(ValueError, match="slots"):
        tmerge.launch_plan(10, 116, 65)
    tile = tmerge.BLOCK * tmerge.WIDE_WORDS
    with pytest.raises(ValueError, match="grid"):
        tmerge.launch_plan(10, 4 * (tile * tmerge.MAX_GRID_Y + 1), 4)
    tmerge.launch_plan(10, 4 * tile * tmerge.MAX_GRID_Y, 4)
    # the wide route with a scale table takes one word a lane
    with pytest.raises(ValueError, match="grid"):
        tmerge.launch_plan(10, 4 * tile * tmerge.MAX_GRID_Y, 4, torch.int8)
    with pytest.raises(TypeError):
        tmerge.launch_plan(10, 116, 6, torch.float16)


def test_index_table_is_never_cast():
    idx = torch.arange(12, dtype=torch.int64).reshape(3, 4)
    assert tmerge._index_table(idx).data_ptr() == idx.data_ptr()
    for dtype in (torch.int32, torch.int16):
        with pytest.raises(TypeError, match="int64"):
            tmerge._index_table(idx.to(dtype))


def test_plan_args_are_made_once_per_shape():
    args = tmerge._plan_args(50_000, 116, 6, torch.float32, True, False)
    assert tmerge._plan_args(50_000, 116, 6, torch.float32, True,
                             False) is args
    plan = tmerge.launch_plan(50_000, 116, 6, torch.float32, True, False)
    assert list(args) == [int(plan.vec), int(plan.wide), plan.group,
                          plan.threads, *plan.grid, plan.words_per_lane,
                          plan.in_flight]


# -- the plain versions against the JAX kernels at the route edges ----------

def edge_case(f, k, seed):
    """37 rows, a 2-cell ring, half the slots live; rows 0, 5, ... have no
    live slot and rows 1, 6, ... only live ones, so -0.0 in p (column
    f // 2 of every third row, and of the first cell) ends as -0.0 or
    +0.0. Empty slots name the second cell, whose rows are NaN or Inf, and
    one in four carries w_self = 0.75."""
    rng = np.random.default_rng(seed)
    n, m = EDGE_N, 2 * EDGE_N
    p = rng.normal(size=(n, f)).astype(np.float32)
    h = rng.normal(size=(m, f)).astype(np.float32)
    p[::3, f // 2] = -0.0
    h[:n, f // 2] = -0.0
    h[n:] = np.nan
    h[n::5] = np.inf
    on = rng.uniform(size=(n, k)) < 0.5
    on[::5] = False
    on[1::5] = True
    idx = np.where(on, rng.integers(0, n, (n, k)), rng.integers(n, m, (n, k)))
    wp = np.where(on, rng.uniform(0.1, 0.9, (n, k)), 0.0).astype(np.float32)
    ws = np.where(on, 1.0 - wp,
                  np.where(rng.uniform(size=(n, k)) < 0.25, 0.75, 1.0))
    return p, h, idx.astype(np.int64), ws.astype(np.float32), wp


def assert_same_zeros(got, want):
    zero = want == 0
    assert zero.any()
    np.testing.assert_array_equal(got == 0, zero)
    np.testing.assert_array_equal(np.signbit(got[zero]),
                                  np.signbit(want[zero]))


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("k", [1, 6, 59, 64])
@pytest.mark.parametrize("f", [1, 3, 4, 60, 116, 132])
def test_plain_matches_jax_kernel_at_route_edges(f, k, wire):
    p, h, idx, ws, wp = edge_case(f, k, seed=f * 100 + k)
    scale = None
    hj, ht = jnp.asarray(h), torch.from_numpy(h)
    if wire == "bfloat16":
        hj, ht = hj.astype(jnp.bfloat16), ht.to(torch.bfloat16)
    elif wire == "int8":
        rng = np.random.default_rng(f + k)
        q = rng.integers(-127, 128, h.shape).astype(np.int8)
        scale = rng.uniform(0.001, 0.02, h.shape[0]).astype(np.float32)
        scale[EDGE_N:] = np.nan       # named by empty slots only
        scale[EDGE_N::5] = np.inf
        hj, ht = jnp.asarray(q), torch.from_numpy(q)
    tab = torch.from_numpy(idx)
    assert tab.dtype == torch.int64
    got = tmerge.gather_merge_multi(
        torch.from_numpy(p), ht, tab, torch.from_numpy(ws),
        torch.from_numpy(wp),
        None if scale is None else torch.from_numpy(scale)).numpy()
    want = np.asarray(gather_merge_multi(
        jnp.asarray(p), hj, jnp.asarray(idx), jnp.asarray(ws),
        jnp.asarray(wp), None if scale is None else jnp.asarray(scale),
        interpret=True))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    assert_same_zeros(got, want)


def test_wrappers_take_int64_tables_on_cpu():
    p, h, idx, ws, wp = edge_case(116, 6, seed=3)
    args = [torch.from_numpy(a) for a in (p, h, idx, ws, wp)]
    assert args[2].dtype == torch.int64
    tmerge.reset_launch_counts()
    got64 = tmerge.gather_merge_multi(*args)
    assert sum(tmerge.LAUNCHES.values()) == 0
    # -0.0 in p: +0.0 after a row of empty slots, -0.0 after live ones
    # whose peers hold -0.0 there.
    col = got64[:, 116 // 2]
    assert bool((col[::15] == 0).all()) and not bool(col[::15].signbit().any())
    assert bool((col[6::15] == 0).all()) and bool(col[6::15].signbit().all())
