"""K5's float32 routes as 3xTF32 (``csrc/flash_hop_tf32.cu``: 128-row
query tiles for D, Dv up to 128, 64-row ones up to 256), on the CPU.

The routes split every float32 operand into TF32 high and low parts and
compute each product as three TF32 products. Their CUDA kernels run on the
card only (``chip_smoke.py`` holds them against their plain versions
there); here the plain versions are held to a bit-level numpy rounding
and to the JAX kernel ``_hop_kernel`` (Pallas interpret mode):

- ``tf32_round`` / ``tf32_split_reference`` equal numpy's
  round-to-nearest-ties-away on the raw bits, bit for bit, up to 8 groups
  of 32 columns;
- ``flash_hop_update_tf32_reference`` (each route's tiles, work list,
  piece merge and 3xTF32 products) matches the JAX kernel within
  ``chip_smoke.check_hop``'s tolerances, and with its low parts dropped
  (one TF32 product) it does not: the check sees the precision;
- ``hop_schedule`` with each route's tiles covers every needed
  (query, key) tile pair once;
- the work lists cached for the card keep every table they handed out.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import hop_arrays
from gossipy_tpu.ops import attention as jattn
from gossipy_tpu_torch import ops as tops
from gossipy_tpu_torch.ops import attention as tattn
from test_torch_attention import assert_within_check_hop, to_jax, to_torch

torch.set_num_threads(1)
NEG = tattn._NEG


def np_tf32(x: np.ndarray) -> np.ndarray:
    """Round float32 to TF32 on the bits: to nearest, ties away from zero
    (add half of the 2^13 step to the magnitude, clear the low 13 bits)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    sign = bits & np.uint32(0x80000000)
    mag = ((bits & np.uint32(0x7FFFFFFF)) + np.uint32(0x1000)) \
        & np.uint32(0xFFFFE000)
    return (sign | mag).view(np.float32)


def edge_values(rows, cols, seed):
    """Normal values with exact ties of the high part and of the low part,
    mantissas that round into the next binade, both zeros, subnormals and
    flipped signs."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, cols)).astype(np.float32)
    bits = x.view(np.uint32).reshape(-1)
    picks = rng.permutation(bits.size)[:6 * (bits.size // 7)].reshape(6, -1)
    bits[picks[0]] = (bits[picks[0]] & ~np.uint32(0x1FFF)) | np.uint32(0x1000)
    bits[picks[1]] = (bits[picks[1]] & ~np.uint32(0xFFF)) | np.uint32(0x800)
    bits[picks[2]] |= np.uint32(0x7FFFFF)
    bits[picks[3]] = np.uint32(0x80000000) * (picks[3] % 2).astype(np.uint32)
    bits[picks[4]] &= np.uint32(0x807FFFFF)
    bits[picks[5]] ^= np.uint32(0x80000000)
    return x


def test_tf32_round_equals_numpy_bits():
    x = edge_values(64, 40, 0)
    got = tattn.tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  np_tf32(x).view(np.uint32))
    # The cases themselves: a tie goes away from zero, zeros keep their
    # sign, a mantissa of all ones carries into the exponent.
    cases = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 0.0, -0.0,
                      np.nextafter(np.float32(2), np.float32(0))],
                     np.float32)
    want = np.array([1 + 2.0 ** -10, -(1 + 2.0 ** -10), 0.0, -0.0, 2.0],
                    np.float32)
    got = tattn.tf32_round(torch.from_numpy(cases)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    hi, lo = tattn.tf32_parts(torch.from_numpy(x))
    np.testing.assert_array_equal(lo.numpy().view(np.uint32), np_tf32(
        x - np_tf32(x)).view(np.uint32))
    assert not (hi.numpy().view(np.uint32) & 0x1FFF).any()


@pytest.mark.parametrize("shape", [(13, 21, 40, 50), (70, 77, 72, 8),
                                   (64, 64, 128, 128), (13, 21, 150, 40),
                                   (9, 30, 64, 180), (20, 17, 200, 8),
                                   (11, 12, 256, 256)])
def test_tf32_split_reference_equals_numpy(shape):
    """The pre-pass's planes: q and k hi/lo padded to 32 G columns, v^T
    hi/lo padded to 32 G rows and ``sl_k`` rounded up to 8 keys, keys of
    each 8-key group in the order (0, 2, 4, 6, 1, 3, 5, 7)."""
    sl_q, sl_k, dim, dv = shape
    q, k, v = (edge_values(r, c, i) for i, (r, c) in
               enumerate(((sl_q, dim), (sl_k, dim), (sl_k, dv))))
    cols = 32 * tattn.tf32_groups(dim, dv)
    ld_k = -(-sl_k // 8) * 8
    tops.reset_launch_counts()
    qs, ks, vt = tops.tf32_split(*map(torch.from_numpy, (q, k, v)))
    assert sum(tops.LAUNCHES.values()) == 0      # CPU tensors: plain
    assert qs.shape == (2, sl_q, cols) and ks.shape == (2, sl_k, cols)
    assert vt.shape == (2, cols, ld_k)

    def planes(x):
        hi = np_tf32(x)
        return np.stack([hi, np_tf32(x - hi)])

    pad = np.zeros((ld_k, cols), np.float32)
    pad[:sl_k, :dv] = v
    perm = np.arange(ld_k).reshape(-1, 8)[:, [0, 2, 4, 6, 1, 3, 5, 7]]
    for got, want in ((qs, planes(np.pad(q, ((0, 0), (0, cols - dim))))),
                      (ks, planes(np.pad(k, ((0, 0), (0, cols - dim))))),
                      (vt, planes(np.ascontiguousarray(
                          pad[perm.reshape(-1)].T)))):
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.view(np.uint32))


# (sl_q, sl_k, D, Dv, causal, (q_off, k_off), carry, masked rows, n_sm)
TF32_CASES = {
    # The demo's own hop: S = 256, D = 32, non-causal, the initial carry.
    "demo-shape": (256, 256, 32, 32, False, (0, 0), "initial", 0, 132),
    # Ragged and causal mid-stream at D = 72, query tiles cut into pieces
    # merged in the launch (1000 SMs: every key tile a piece).
    "ragged-causal-mid": (200, 150, 72, 72, True, (120, 0), "mid", 0, 1000),
    # Rows 0..63 see only keys after them and enter at m = _NEG: they keep
    # l = 0 and m = _NEG.
    "masked-rows": (192, 160, 40, 24, True, (0, 64), "mid", 64, 132),
}


@pytest.mark.parametrize("name", sorted(TF32_CASES))
def test_tf32_reference_matches_jax_kernel(name):
    (sl_q, sl_k, dim, dv, causal, (qo, ko), carry, masked,
     n_sm) = TF32_CASES[name]
    ops = hop_arrays(sl_q, sl_k, dim, dv, carry, len(name), NEG, masked)
    scale = 1.0 / np.sqrt(dim)
    want = jattn.flash_hop_update(*to_jax(ops), qo, ko, scale, causal=causal,
                                  interpret=True)
    got = tops.flash_hop_update_tf32_reference(*to_torch(ops), qo, ko, scale,
                                               causal, n_sm=n_sm)
    assert all(t.dtype == torch.float32 for t in got)
    assert_within_check_hop(got, want, dv)
    sched = tattn.hop_schedule(sl_q, sl_k, qo, ko, causal,
                               tattn.TF32_BLOCK_K, n_sm, tattn.TF32_BLOCK_Q)
    if n_sm == 1000:
        assert sched.n_slots > 0        # partial carries were merged
    if masked:
        np.testing.assert_array_equal(got[1][:masked].numpy(), 0.0)
        np.testing.assert_array_equal(got[0][:masked].numpy(),
                                      np.float32(NEG))


# The wide route's tiles: 64-row query tiles, 32-key tiles (16 at 8 groups
# of 32 columns). (sl_q, sl_k, D, Dv, causal, (q_off, k_off), carry, n_sm);
# 1000 SMs cut every query tile into pieces merged in the launch.
TF32_WIDE_CASES = {
    "256-causal-mid": (300, 260, 256, 256, True, (100, 0), "mid", 132),
    "256-noncausal": (256, 256, 256, 256, False, (0, 0), "initial", 132),
    "64-200-causal-mid": (200, 180, 64, 200, True, (50, 0), "mid", 132),
    "200-40-noncausal": (200, 180, 200, 40, False, (0, 0), "mid", 132),
    "64-200-noncausal-split": (130, 200, 64, 200, False, (0, 0), "mid",
                               1000),
    "200-40-causal-split": (130, 200, 200, 40, True, (60, 0), "mid", 1000),
}


@pytest.mark.parametrize("name", sorted(TF32_WIDE_CASES))
def test_tf32_wide_reference_matches_jax_kernel(name):
    """The model with the wide route's tiles, seed 7: within check_hop's
    tolerances, and one TF32 product is not."""
    (sl_q, sl_k, dim, dv, causal, (qo, ko), carry,
     n_sm) = TF32_WIDE_CASES[name]
    assert tattn.route(torch.float32, dim, dv) == tattn.F32_WIDE_ROUTE
    ops = hop_arrays(sl_q, sl_k, dim, dv, carry, 7, NEG)
    scale = 1.0 / np.sqrt(dim)
    want = jattn.flash_hop_update(*to_jax(ops), qo, ko, scale, causal=causal,
                                  interpret=True)
    got = tops.flash_hop_update_tf32_reference(*to_torch(ops), qo, ko, scale,
                                               causal, n_sm=n_sm)
    assert all(t.dtype == torch.float32 for t in got)
    assert_within_check_hop(got, want, dv)
    one = tops.flash_hop_update_tf32_reference(*to_torch(ops), qo, ko, scale,
                                               causal, n_sm=n_sm,
                                               low_parts=False)
    m_w = np.asarray(want[0], np.float64)
    assert np.max(np.abs(one[0].double().numpy() - m_w)
                  / np.maximum(1.0, np.abs(m_w))) > 1e-5
    bq, bk = tattn.tf32_tiles(dim, dv)
    sched = tattn.hop_schedule(sl_q, sl_k, qo, ko, causal, bk, n_sm, bq)
    if n_sm == 1000:
        assert min(it[4] for it in sched.items) > 1   # every tile merged


def test_plain_tf32_exceeds_the_m_tolerance():
    """One TF32 product (low parts dropped) is ~5e-4 off in m on normal
    data, beyond the 1e-5 relative tolerance; the three products are
    within it."""
    ops = hop_arrays(256, 256, 32, 32, "initial", 3, NEG)
    scale = 1.0 / np.sqrt(32)
    want = jattn.flash_hop_update(*to_jax(ops), 0, 0, scale, interpret=True)
    m_w = np.asarray(want[0], np.float64)

    def m_err(low_parts):
        got = tops.flash_hop_update_tf32_reference(
            *to_torch(ops), 0, 0, scale, low_parts=low_parts)
        m_g = got[0].double().numpy()
        return np.max(np.abs(m_g - m_w) / np.maximum(1.0, np.abs(m_w)))

    assert m_err(False) > 1e-5
    assert m_err(True) <= 1e-5


# (sl_q, sl_k, q_off, k_off, causal, n_sm)
TF32_SCHEDULES = {
    "train-noncausal": (8192, 8192, 0, 0, False, 132),
    "bench-causal": (8192, 8192, 0, 0, True, 132),
    "ragged-few-sms": (700, 900, 100, 300, True, 7),
    "split-every-tile": (200, 640, 640, 0, True, 132),
    "chunk-after-queries": (128, 300, 0, 512, True, 132),
}


@pytest.mark.parametrize("name", sorted(TF32_SCHEDULES))
def test_hop_schedule_with_the_tf32_tiles_covers_every_pair_once(name):
    sl_q, sl_k, qo, ko, causal, n_sm = TF32_SCHEDULES[name]
    bq, bk = tattn.TF32_BLOCK_Q, tattn.TF32_BLOCK_K
    sched = tattn.hop_schedule(sl_q, sl_k, qo, ko, causal, bk, n_sm, bq)
    n_qt = -(-sl_q // bq)
    assert sched.n_q_tiles == n_qt
    q_pos, k_pos = qo + np.arange(sl_q), ko + np.arange(sl_k)
    want = {(t, j) for t in range(n_qt) for j in range(-(-sl_k // bk))
            if not causal or k_pos[j * bk] <= q_pos[t * bq:(t + 1) * bq].max()}
    got = [(it[0], kt) for it in sched.items for kt in range(it[1], it[2])]
    assert len(got) == len(set(got)) and set(got) == want
    assert sum(sched.loads) == len(want)
    assert sorted({it[0] for it in sched.items}) == list(range(n_qt))
    slots = sorted(it[5] for it in sched.items if it[4] > 1)
    assert slots == list(range(sched.n_slots))
    mean = len(want) / n_sm
    assert max(sched.loads) <= max(1.5 * mean, mean + 4)


# (sl_q, sl_k, q_off, k_off, causal, n_sm, D, Dv): the wide route's lists.
TF32_WIDE_SCHEDULES = {
    "wide-run-causal": (2048, 2048, 0, 0, True, 132, 256, 256),
    "g7-noncausal": (1000, 777, 0, 0, False, 132, 200, 40),
    "ragged-few-sms": (700, 900, 100, 300, True, 7, 64, 180),
    "split-every-tile": (128, 4096, 4096, 0, True, 132, 256, 256),
    "chunk-after-queries": (64, 300, 0, 512, True, 132, 150, 150),
}


@pytest.mark.parametrize("name", sorted(TF32_WIDE_SCHEDULES))
def test_hop_schedule_with_the_wide_tiles_covers_every_pair_once(name):
    sl_q, sl_k, qo, ko, causal, n_sm, dim, dv = TF32_WIDE_SCHEDULES[name]
    bq, bk = tattn.tf32_tiles(dim, dv)
    assert bq == tattn.TF32_WIDE_BLOCK_Q
    assert bk == (16 if max(dim, dv) > 224 else 32)
    sched = tattn.hop_schedule(sl_q, sl_k, qo, ko, causal, bk, n_sm, bq)
    n_qt = -(-sl_q // bq)
    assert sched.n_q_tiles == n_qt
    q_pos, k_pos = qo + np.arange(sl_q), ko + np.arange(sl_k)
    want = {(t, j) for t in range(n_qt) for j in range(-(-sl_k // bk))
            if not causal or k_pos[j * bk] <= q_pos[t * bq:(t + 1) * bq].max()}
    got = [(it[0], kt) for it in sched.items for kt in range(it[1], it[2])]
    assert len(got) == len(set(got)) and set(got) == want
    assert sorted({it[0] for it in sched.items}) == list(range(n_qt))
    slots = sorted(it[5] for it in sched.items if it[4] > 1)
    assert slots == list(range(sched.n_slots))
    if want:
        mean = len(want) / n_sm
        assert max(sched.loads) <= max(1.5 * mean, mean + 4)


def test_work_list_cache_keeps_every_table():
    """A table handed out is the same live object, with the same contents,
    after 70 other hops' lists were cached (a CUDA graph keeps its
    address); while capturing, a cached list is handed out and a new one
    raises."""
    saved = dict(tattn._SCHEDULES)
    tattn._SCHEDULES.clear()
    try:
        args = ("cpu", 132, 300, 500, 400, 0, True, 16, 64)
        first = tattn._cached_schedule(*args)
        table, ptr = first[0], first[0].data_ptr()
        np.testing.assert_array_equal(table.numpy(), tattn.hop_schedule(
            300, 500, 400, 0, True, 16, 132, 64).table)
        contents = table.clone()
        for i in range(70):
            tattn._cached_schedule("cpu", 132, 300, 500, 1000 + 7 * i, 0,
                                   True, 16, 64)
        assert len(tattn._SCHEDULES) == 71
        again = tattn._cached_schedule(*args, capturing=True)
        assert again is first and again[0] is table
        assert table.data_ptr() == ptr and torch.equal(table, contents)
        with pytest.raises(RuntimeError, match="before capturing"):
            tattn._cached_schedule("cpu", 132, 300, 500, 1, 0, True, 16, 64,
                                   capturing=True)
    finally:
        tattn._SCHEDULES.clear()
        tattn._SCHEDULES.update(saved)


def test_route_picks_by_type_and_width():
    assert tattn.route(torch.bfloat16, 256, 256) == tattn.BF16_ROUTE
    assert tattn.route(torch.float32, 32, 32) == tattn.F32_ROUTE
    assert tattn.route(torch.float32, 128, 72) == tattn.F32_ROUTE
    assert tattn.route(torch.float32, 129, 8) == tattn.F32_WIDE_ROUTE
    assert tattn.route(torch.float32, 64, 150) == tattn.F32_WIDE_ROUTE
    for dim, dv in ((256, 256), (64, 200), (200, 40)):
        assert tattn.route(torch.float32, dim, dv) == tattn.F32_WIDE_ROUTE
    with pytest.raises(TypeError):
        tattn.route(torch.float16, 32, 32)
    assert tattn.SOURCES[tattn.F32_ROUTE] == "flash_hop_tf32"
    assert tattn.SOURCES[tattn.F32_WIDE_ROUTE] == "flash_hop_tf32"
    assert [tattn.tf32_groups(d, dv) for d, dv in
            ((32, 32), (64, 40), (72, 72), (128, 128), (8, 100), (129, 8),
             (64, 180), (200, 40), (256, 256))] == [1, 2, 3, 4, 4, 5, 6, 7, 8]
    assert [tattn.tf32_tiles(d, dv) for d, dv in
            ((128, 128), (129, 8), (200, 40), (225, 8), (256, 256))] == \
        [(128, 32), (64, 32), (64, 32), (64, 16), (64, 16)]
