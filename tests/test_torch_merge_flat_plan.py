"""K3/K4's launch plan, their wrapper's plumbing and their plain versions
at the edges of the routes.

``flat_plan`` is the pure Python function that maps a single-slot call
onto the card: a group of G lanes a row (G the power of two at or above
the row's words) for rows of up to 32 words, a block per (row, tile) for
wider rows, the tiles of a row of one size. The CUDA kernel follows the
mapping that ``cells`` below spells out; here it is held to cover every
row and word exactly once within the card's grid limits at the shapes
the paths give K3/K4 (the token north star's 100 x 116, phase 4's and
the flagship's CIFAR10Net rows), at ``chip_smoke.py``'s ragged shapes and
route edges, and where a row's tiles change in number. The plan's
constants are held to the kernel source's.

The wrapper is held, with the launch stubbed, to pass the engine's int64
index table as it is (never cast: a cast is a second kernel a call) and
``flat_plan``'s values to the C entry point, and to refuse any other
index type on the kernel route.

The plain versions of K3 and K4 (bf16, int8) are held against the JAX
``gather_merge_flat`` in Pallas interpret mode at those edges: values
within ``atol = rtol = 1e-6`` (the JAX kernel's XLA program may round a
multiply-add once), zeros at the same places with the same signs, and a
NaN ring row behind ``w_peer = 0`` reaching its receiver (no zero-weight
mask, as in the JAX kernel). The kernels are held bit for bit to these
plain versions on the card by ``chip_smoke.py``.
"""

import contextlib
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipy_tpu.ops.merge import gather_merge_flat
from gossipy_tpu_torch.ops import _build
from gossipy_tpu_torch.ops import merge as tmerge

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-6)
CIFAR_STRIDE = 73420   # CIFAR10Net's flat row
LOGREG_STRIDE = 116    # LogisticRegression(57, 2)'s
EDGE_F = (1, 3, 4, 60, 116, 128, 132)   # chip_smoke.SWEEP_EDGE_F
EDGE_N = 37                             # chip_smoke.SWEEP_EDGE_N
DTYPES = (torch.float32, torch.bfloat16, torch.int8)

# (n, f): the paths' shapes and chip_smoke.py's ragged ones.
SHAPES = [(100, LOGREG_STRIDE),       # token north star, north star per_slot
          (64, CIFAR_STRIDE),         # phase 4's per_slot rows
          (100, CIFAR_STRIDE),        # the flagship's
          (64, CIFAR_STRIDE - 2),     # the scalar form of a wide row
          (5, 37), (6, 44)]           # phase 3's ragged shapes


def cells(plan):
    """The ``(row, word)`` each lane of the plan's grid takes, as the
    kernel maps them (``[grid_x, grid_y, threads, words_per_lane]``
    arrays), and whether the lane takes it: narrow, lane t of block x
    takes row x * rows_per_block + t // group and word t % group; wide,
    lane t of block (x, y) takes row x and words y * tile + i * threads +
    t that lie inside the tile."""
    bx = torch.arange(plan.grid[0])[:, None, None, None]
    by = torch.arange(plan.grid[1])[None, :, None, None]
    t = torch.arange(plan.threads)[None, None, :, None]
    i = torch.arange(plan.words_per_lane)[None, None, None, :]
    shape = (plan.grid[0], plan.grid[1], plan.threads, plan.words_per_lane)
    if plan.wide:
        row = bx.expand(shape)
        in_tile = (i * plan.threads + t).expand(shape)
        word = by * plan.tile + in_tile
        return row, word, in_tile < plan.tile
    row = (bx * plan.rows_per_block + t // plan.group).expand(shape)
    word = (t % plan.group + 0 * i).expand(shape)
    return row, word, torch.ones(shape, dtype=torch.bool)


def check_plan(n, f, dtype=torch.float32, aligned=True, scaled=False):
    plan = tmerge.flat_plan(n, f, dtype, aligned, scaled)
    assert plan.vec == (aligned and f % 4 == 0)
    assert plan.words == (f // 4 if plan.vec else f)
    assert plan.wide == (plan.words > tmerge.WARP)
    assert plan.threads % tmerge.WARP == 0
    assert tmerge.WARP <= plan.threads <= tmerge.BLOCK
    assert plan.grid[0] <= tmerge.MAX_GRID_X
    assert plan.grid[1] <= tmerge.MAX_GRID_Y
    if plan.wide:
        assert plan.group == tmerge.WARP and plan.rows_per_block == 1
        assert plan.words_per_lane == tmerge.WIDE_WORDS
        assert plan.grid[0] == n
        assert plan.tile <= plan.threads * plan.words_per_lane
        # as few tiles as the block's lanes allow, all of one size, as
        # even as their count allows
        per_block = tmerge.BLOCK * plan.words_per_lane
        assert plan.grid[1] == -(-plan.words // per_block)
        assert plan.tile == -(-plan.words // plan.grid[1])
    else:
        assert plan.words <= plan.group <= tmerge.WARP
        assert plan.group == tmerge._pow2_at_least(plan.words)
        assert plan.rows_per_block * plan.group == plan.threads
        assert plan.words_per_lane == 1 and plan.grid[1] == 1
    row, word, taken = cells(plan)
    on = taken & (row < n) & (word < plan.words)
    flat = (row[on] * plan.words + word[on]).flatten()
    counts = torch.bincount(flat, minlength=n * plan.words)
    assert counts.numel() == n * plan.words
    assert bool((counts == 1).all())
    # No block is wholly idle: the grid is no larger than it must be.
    busy = on.reshape(plan.grid[0] * plan.grid[1], -1).any(dim=1)
    assert bool(busy.all())
    return plan


@pytest.mark.parametrize("n,f", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_covers_every_row_and_word_once(n, f, dtype):
    plan = check_plan(n, f, dtype)
    check_plan(n, f, dtype, aligned=False)
    check_plan(n, f, dtype, scaled=True)
    if (n, f) == (100, LOGREG_STRIDE):
        # 29 words: 32 lanes a row, 8 rows a block, 13 blocks
        assert (plan.group, plan.rows_per_block, plan.grid) == (32, 8,
                                                                 (13, 1))
    if f == CIFAR_STRIDE:
        # 18,355 words: 36 tiles of 510, 2 words a lane of 256
        assert plan.wide and plan.vec
        assert (plan.grid, plan.tile, plan.threads) == ((n, 36), 510, 256)
    if plan.wide:  # the last tile of a row is not mostly empty
        last = plan.words - (plan.grid[1] - 1) * plan.tile
        assert 2 * last >= plan.tile


@pytest.mark.parametrize("f", EDGE_F)
def test_plan_covers_route_edges(f):
    for dtype in DTYPES:
        for aligned in (True, False):
            plan = check_plan(EDGE_N, f, dtype, aligned)
            assert plan.wide == ((f // 4 if plan.vec else f) > 32)
    # 132 columns: the first wide row, one tile of 33 words on a warp
    plan = tmerge.flat_plan(EDGE_N, f)
    if f == 132:
        assert plan.wide and plan.tile == 33 and plan.threads == 32
    else:
        assert not plan.wide
        assert EDGE_N % plan.rows_per_block != 0 or plan.grid == (1, 1)


# Wide rows where the tiles change in number (512 words fill one tile of
# 256 lanes x 2 words), in the vector and the scalar form.
TILE_EDGES = [(EDGE_N, 4 * 33), (EDGE_N, 4 * 257), (EDGE_N, 4 * 511),
              (EDGE_N, 4 * 512), (EDGE_N, 4 * 513), (3, 4 * 1025),
              (3, 4 * 1025 + 1), (2, 511), (2, 513)]


@pytest.mark.parametrize("n,f", TILE_EDGES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_covers_tile_boundaries(n, f, dtype):
    plan = check_plan(n, f, dtype)
    check_plan(n, f, dtype, aligned=False)
    tiles = -(-plan.words // (tmerge.BLOCK * tmerge.WIDE_WORDS))
    assert plan.wide and plan.grid == (n, tiles)


def test_plan_constants_match_the_kernel_source():
    """flat_plan's words a lane and lanes a block are the kernel's."""
    src = (pathlib.Path(tmerge.__file__).parent.parent / "csrc"
           / "gather_merge_flat.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("kWideWords") == tmerge.WIDE_WORDS
    assert const("kMaxThreads") == tmerge.BLOCK
    assert const("kWarp") == tmerge.WARP


def test_unaligned_operands_take_the_scalar_form():
    for n, f in SHAPES:
        plan = tmerge.flat_plan(n, f, torch.bfloat16, False)
        assert not plan.vec and plan.words == f
    assert tmerge.flat_plan(100, 116, torch.float32, True).vec
    assert not tmerge.flat_plan(100, 118, torch.float32, True).vec


def test_plan_raises_past_its_limits():
    per_lane = tmerge.WIDE_WORDS
    limit = 4 * tmerge.BLOCK * per_lane * tmerge.MAX_GRID_Y
    tmerge.flat_plan(2, limit)
    with pytest.raises(ValueError, match="grid"):
        tmerge.flat_plan(2, limit + 4 * tmerge.BLOCK * per_lane)
    with pytest.raises(ValueError, match="no rows"):
        tmerge.flat_plan(0, 116)
    with pytest.raises(TypeError):
        tmerge.flat_plan(4, 116, torch.float16)


def test_plan_args_are_made_once_per_shape():
    args = tmerge._flat_plan_args(100, 116, torch.float32, True, False)
    assert tmerge._flat_plan_args(100, 116, torch.float32, True,
                                  False) is args
    plan = tmerge.flat_plan(100, 116, torch.float32, True, False)
    assert tmerge.flat_plan(100, 116, torch.float32, True, False) is plan
    assert list(args) == [int(plan.vec), int(plan.wide), plan.group,
                          plan.threads, *plan.grid, plan.words_per_lane,
                          plan.tile]


# -- the wrapper's plumbing, with the launch stubbed --------------------------

@contextlib.contextmanager
def stubbed_launch(monkeypatch):
    """Let the kernel route run on CPU tensors: the CUDA-tensor check,
    the stream and the device context pass, and ``_build.function``
    returns a stub recording what the C entry point would receive."""
    calls = []

    def function(source, entry, argtypes):
        def fn(*args):
            calls.append((source, entry, args))
            return 0
        return fn
    monkeypatch.setattr(tmerge, "_check_kernel_operands",
                        lambda caller, p, h: None)
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    yield calls


def small_case(f, wire, n=6, seed=5):
    rng = np.random.default_rng(seed)
    p = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32))
    h = torch.from_numpy(rng.normal(size=(2 * n, f)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 2 * n, n).astype(np.int64))
    ws = torch.full((n,), 0.5)
    wp = torch.full((n,), 0.5)
    scale = starts = None
    if wire == "bfloat16":
        h = h.to(torch.bfloat16)
    elif wire == "int8":
        h = h.to(torch.int8)
        scale = torch.ones(2 * n, 2)
        starts = torch.tensor([0, f // 2], dtype=torch.int32)
    return p, h, idx, ws, wp, scale, starts


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
def test_wrapper_passes_the_int64_table_and_the_plan(monkeypatch, wire):
    p, h, idx, ws, wp, scale, starts = small_case(116, wire)
    with stubbed_launch(monkeypatch) as calls:
        tmerge.reset_launch_counts()
        tmerge.gather_merge_flat_cuda(p, h, idx, ws, wp, scale, starts)
    (source, entry, args), = calls
    k3 = wire == "float32"
    assert source == "gather_merge_flat"
    assert entry == ("gather_merge_flat" if k3 else "gather_merge_flat_dq")
    # the index table as the engine made it: the same storage, no cast
    assert args[2 if k3 else 3] == idx.data_ptr()
    aligned = p.data_ptr() % 16 == 0 and \
        h.data_ptr() % (4 * h.element_size()) == 0
    want = tmerge._flat_plan_args(6, 116, h.dtype, aligned,
                                  scale is not None)
    assert args[-2] is want
    kernel = tmerge.KERNEL_FLAT if k3 else tmerge.KERNEL_FLAT_DQ
    assert tmerge.LAUNCHES[kernel] == 1
    assert sum(tmerge.LAUNCHES.values()) == 1


@pytest.mark.parametrize("dtype", [torch.int32, torch.int16, torch.uint8])
def test_kernel_route_refuses_a_table_not_int64(monkeypatch, dtype):
    p, h, idx, ws, wp, _, _ = small_case(116, "float32")
    with stubbed_launch(monkeypatch) as calls:
        with pytest.raises(TypeError, match="int64"):
            tmerge.gather_merge_flat_cuda(p, h, idx.to(dtype), ws, wp)
    assert calls == []


def test_cpu_route_takes_any_integer_index():
    p, h, idx, ws, wp, _, _ = small_case(116, "float32")
    want = tmerge.gather_merge_flat(p, h, idx, ws, wp)
    for dtype in (torch.int32, torch.int16, torch.uint8):
        got = tmerge.gather_merge_flat(p, h, idx.to(dtype), ws, wp)
        assert torch.equal(got, want)


def test_one_validation_and_one_kernel_choice_a_call(monkeypatch):
    """The dispatch function checks the operands and names the kernel once;
    the launch below it does neither again."""
    p, h, idx, ws, wp, scale, starts = small_case(116, "int8")
    kernel = tmerge._flat_kernel(h, scale)
    seen = []
    check, choose = tmerge._check_flat, tmerge._flat_kernel
    monkeypatch.setattr(tmerge, "_check_flat",
                        lambda *a: (seen.append("check"), check(*a))[1])
    monkeypatch.setattr(tmerge, "_flat_kernel",
                        lambda *a: (seen.append("kernel"), choose(*a))[1])
    with stubbed_launch(monkeypatch) as calls:
        tmerge._launch_flat(kernel, p, h, idx, ws, wp, scale, starts)
    assert len(calls) == 1 and seen == []
    tmerge.gather_merge_flat(p, h, idx, ws, wp, scale, starts)
    assert seen == ["check", "kernel"]


# -- the plain versions against the JAX kernel at the route edges ------------

def edge_case(f, n, seed, n_leaves):
    """``n`` rows, a 2-cell ring, one slot a row. Rows 0, 4, ... carry
    w_peer = 0 and name a ring row of the second cell, which is NaN
    there; -0.0 in column f // 2 of every third row of p and of the ring's
    first cell."""
    rng = np.random.default_rng(seed)
    m = 2 * n
    p = rng.normal(size=(n, f)).astype(np.float32)
    h = rng.normal(size=(m, f)).astype(np.float32)
    p[::3, f // 2] = -0.0
    h[:n, f // 2] = -0.0
    idx = rng.integers(0, n, n)
    wp = rng.uniform(0.1, 0.9, n).astype(np.float32)
    ws = (1.0 - wp).astype(np.float32)
    idx[::4] = n + np.arange(0, n, 4)
    wp[::4] = 0.0
    ws[::4] = 1.0
    nan_rows = n + np.arange(0, n, 4)
    h[nan_rows] = np.nan
    starts = sorted({0, f // 3, 2 * f // 3})[:n_leaves]
    return p, h, idx.astype(np.int64), ws, wp, nan_rows, starts


def jax_flat(p, hj, idx, ws, wp, scale, starts):
    """The JAX kernel leaf by leaf (its pytree form's launches), each leaf
    with its own per-row scale, in interpret mode."""
    f = p.shape[1]
    bounds = list(starts) + [f]
    parts = []
    for leaf, (a, b) in enumerate(zip(bounds, bounds[1:])):
        sc = None if scale is None else jnp.asarray(scale[:, leaf])
        parts.append(np.asarray(gather_merge_flat(
            jnp.asarray(p[:, a:b]), hj[:, a:b], jnp.asarray(idx),
            jnp.asarray(ws), jnp.asarray(wp), scale=sc, interpret=True)))
    return np.concatenate(parts, axis=1)


def assert_same_zeros(got, want):
    zero = want == 0
    assert zero.any()
    np.testing.assert_array_equal(got == 0, zero)
    np.testing.assert_array_equal(np.signbit(got[zero]),
                                  np.signbit(want[zero]))


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("f", EDGE_F + (37, 44, 4 * 257 + 2))
def test_plain_matches_jax_kernel_at_route_edges(f, wire):
    n = EDGE_N
    p, h, idx, ws, wp, nan_rows, starts = edge_case(f, n, f * 7 + 1, 3)
    scale = None
    hj, ht = jnp.asarray(h), torch.from_numpy(h)
    if wire == "bfloat16":
        hj, ht = hj.astype(jnp.bfloat16), ht.to(torch.bfloat16)
        starts = [0]
    elif wire == "int8":
        rng = np.random.default_rng(f)
        q = rng.integers(-127, 128, h.shape).astype(np.int8)
        q[:n, f // 2] = 0            # a +0 peer beside p's -0.0
        scale = rng.uniform(0.001, 0.02, (2 * n, len(starts))).astype(
            np.float32)
        scale[nan_rows] = np.nan     # named by w_peer = 0 rows only
        hj, ht = jnp.asarray(q), torch.from_numpy(q)
    else:
        starts = [0]
    tab = torch.from_numpy(idx)
    assert tab.dtype == torch.int64
    got = tmerge.gather_merge_flat(
        torch.from_numpy(p), ht, tab, torch.from_numpy(ws),
        torch.from_numpy(wp),
        None if scale is None else torch.from_numpy(scale),
        None if scale is None else starts).numpy()
    want = jax_flat(p, hj, idx, ws, wp, scale, starts)
    np.testing.assert_allclose(got, want, **TOL)
    # no zero-weight mask: the NaN behind w_peer = 0 reaches its row
    dead = np.arange(0, n, 4)
    assert np.isnan(got[dead]).all()
    live = np.setdiff1d(np.arange(n), dead)
    assert np.isfinite(got[live]).all()
    assert_same_zeros(got[live], want[live])
