"""The port's attention path against the JAX package's.

On the CPU the port's ``flash_hop_update`` runs the plain version of K5
(``flash_hop_update_reference``); it is held against the JAX kernel
``_hop_kernel`` in Pallas interpret mode, as the JAX package's own tests
run it off-TPU. ``hop_update_reference`` and ``flash_attention`` are held
against the JAX functions of the same names, the hand-derived backward
against ``_hop_bwd_math`` on the same residuals and cotangents, ``adam``
against ``optax.adam``, and the demo twin against the JAX demo's loss and
step. Inputs are made with ``numpy.random.default_rng``. Tolerances: 1e-5
absolute in float32 (both sides compute in float32 and differ only in the
order of the sums), 1e-6 for adam (elementwise, same operation order).
The bf16 route's work list (``hop_schedule``) is checked for coverage and
balance, and its plain model (``flash_hop_update_split_reference``)
against the JAX kernel at ``chip_smoke.check_hop``'s tolerances (the
route rounds ``p`` to a bf16 high and low part and merges partial
carries, so it is not held to 1e-5). The CUDA kernels are held against
the plain version on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from chip_smoke import hop_arrays
from gossipy_tpu.ops import attention as jattn
from gossipy_tpu_torch import ops as tops
from gossipy_tpu_torch.examples import demo_ring_attention as demo
from gossipy_tpu_torch.ops import _build
from gossipy_tpu_torch.ops import attention as tattn
from gossipy_tpu_torch.optim import adam, apply_updates

torch.set_num_threads(1)
NEG = tattn._NEG
ATOL = 1e-5


def hop_case(sl_q, sl_k, dim, dv, seed=0, carry="initial", masked_rows=0):
    """Operands of one hop, as ``chip_smoke.py`` builds them on the card:
    q, k_c, v_c and the initial carry (m = _NEG, l = 0, acc = 0) or a
    mid-stream one (random m, softplus l, random acc); with
    ``masked_rows`` the first rows of a mid-stream carry enter with
    m = _NEG."""
    return hop_arrays(sl_q, sl_k, dim, dv, carry, seed, NEG, masked_rows)


def to_torch(arrays, dtype=None):
    out = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    if dtype is not None:
        out[:3] = [t.to(dtype) for t in out[:3]]
    return out


def to_jax(arrays, dtype=None):
    out = [jnp.asarray(a) for a in arrays]
    if dtype is not None:
        out[:3] = [a.astype(dtype) for a in out[:3]]
    return out


def assert_carry_close(got, want, atol=ATOL):
    for name, g, w in zip(("m", "l", "acc"), got, want):
        g = g.detach().float().numpy()
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)


# (sl_q, sl_k, D, Dv, causal, (q_off, k_off), carry, block_q, block_k, dtype)
HOP_CASES = {
    "noncausal": (16, 16, 8, 8, False, (0, 0), "initial", 128, 512, "f32"),
    "causal": (16, 16, 8, 8, True, (0, 0), "initial", 128, 512, "f32"),
    # The JAX package's own mid-stream case: a chunk wholly in the future.
    "mid-stream-future": (16, 16, 8, 8, True, (16, 32), "mid", 128, 512,
                          "f32"),
    "mid-stream-crossing": (16, 24, 8, 12, True, (24, 16), "mid", 128, 512,
                            "f32"),
    "ragged-bq16-bk16": (24, 40, 8, 8, True, (8, 0), "mid", 16, 16, "f32"),
    "ragged-bq8": (24, 40, 12, 16, False, (0, 0), "initial", 8, 512, "f32"),
    "bf16": (16, 24, 8, 8, True, (8, 0), "mid", 128, 16, "bf16"),
}


@pytest.mark.parametrize("name", sorted(HOP_CASES))
def test_hop_matches_jax_kernel(name):
    sl_q, sl_k, dim, dv, causal, (qo, ko), carry, bq, bk, dt = HOP_CASES[name]
    ops = hop_case(sl_q, sl_k, dim, dv, seed=len(name), carry=carry)
    scale = 1.0 / np.sqrt(dim)
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if dt == "bf16" else (None,
                                                                    None)
    want = jattn.flash_hop_update(*to_jax(ops, jdt), qo, ko, scale,
                                  causal=causal, interpret=True, block_q=bq,
                                  block_k=bk)
    got = tops.flash_hop_update(*to_torch(ops, tdt), qo, ko, scale,
                                causal=causal, block_q=bq, block_k=bk)
    assert all(t.dtype == torch.float32 for t in got)
    assert_carry_close(got, want)


def test_fully_masked_rows_follow_the_kernel():
    """Rows whose whole chunk is causally masked while m = _NEG: the kernel
    (and the port's flash_hop_update) leaves l at 0; the plain jnp body
    (and the port's hop_update_reference) adds exp(0) = 1 per masked key."""
    sl, dim = 16, 8
    # Offsets (0, 8): keys 8..23 lie after queries 0..7 (wholly masked).
    ops = hop_case(sl, sl, dim, dim, seed=5, carry="mid", masked_rows=8)
    scale = 1.0 / np.sqrt(dim)
    kernel = jattn.flash_hop_update(*to_jax(ops), 0, 8, scale, causal=True,
                                    interpret=True)
    got = tops.flash_hop_update(*to_torch(ops), 0, 8, scale, causal=True)
    assert_carry_close(got, kernel)
    np.testing.assert_array_equal(got[1][:8].numpy(), 0.0)
    np.testing.assert_array_equal(got[0][:8].numpy(), np.float32(NEG))

    plain_j = jattn.hop_update_reference(*to_jax(ops), 0, 8, scale, True)
    plain_t = tops.hop_update_reference(*to_torch(ops), 0, 8, scale, True)
    assert_carry_close(plain_t, plain_j)
    # Rows 0..7 see all 16 keys masked: the plain body counts each. Rows
    # 8..15 have live keys and a real m, and the two agree there.
    np.testing.assert_array_equal(plain_t[1][:8].numpy(), 16.0)
    assert_carry_close([t[8:] for t in plain_t], [t[8:] for t in kernel])


@pytest.mark.parametrize("causal,offs,carry", [
    (False, (0, 0), "initial"),
    (True, (16, 32), "mid"),
    (True, (24, 16), "mid"),
])
def test_hop_update_reference_matches_jax(causal, offs, carry):
    ops = hop_case(16, 24, 8, 12, seed=3, carry=carry)
    scale = 1.0 / np.sqrt(8)
    want = jattn.hop_update_reference(*to_jax(ops), *offs, scale, causal)
    got = tops.hop_update_reference(*to_torch(ops), *offs, scale, causal)
    assert_carry_close(got, want)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_jax(causal):
    rng = np.random.default_rng(11)
    q, k, v = (rng.normal(size=(32, 16)).astype(np.float32)
               for _ in range(3))
    want = jattn.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                 interpret=True)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tops.reset_launch_counts()
    got = tops.flash_attention(*t, causal=causal)
    plain = tops.flash_attention_reference(*t, causal=causal)
    assert sum(tops.LAUNCHES.values()) == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    assert torch.equal(got, plain)


def tied_case(sl_q, sl_k, dim, seed):
    """Scores with exactly tied row maxima: q has positive rows along the
    ones vector and two identical keys hold the largest row sum, so every
    row's max is reached twice."""
    rng = np.random.default_rng(seed)
    q = (rng.uniform(0.5, 1.5, size=(sl_q, 1))
         * np.ones((1, dim))).astype(np.float32)
    k = rng.integers(0, 2, size=(sl_k, dim)).astype(np.float32)
    k[2] = 1.0
    k[5] = 1.0
    return q, k


@pytest.mark.parametrize("case", ["noncausal", "causal-mid", "ties"])
def test_backward_matches_hop_bwd_math(case):
    sl_q, sl_k, dim, dv = 12, 16, 8, 6
    causal = case != "noncausal"
    offs = (8, 0) if case == "causal-mid" else (0, 0)
    q, k, v, m, l, acc = hop_case(sl_q, sl_k, dim, dv, seed=7, carry="mid")
    if case == "ties":
        q, k = tied_case(sl_q, sl_k, dim, seed=8)
        # Half the rows enter with m above every score (the max routes to
        # m_in), half below (it splits over the two tied keys).
        m = np.where(np.arange(sl_q) % 2 == 0, 100.0, -100.0).astype(
            np.float32)
    rng = np.random.default_rng(9)
    gm = rng.normal(size=sl_q).astype(np.float32)
    gl = rng.normal(size=sl_q).astype(np.float32)
    gacc = rng.normal(size=(sl_q, dv)).astype(np.float32)
    scale = 1.0 / np.sqrt(dim)

    res = (*to_jax((q, k, v, m, l, acc)), jnp.asarray(offs, jnp.int32))
    want = jattn._hop_bwd_math(scale, causal, res, tuple(
        map(jnp.asarray, (gm, gl, gacc))))[:6]

    inputs = [t.requires_grad_(True) for t in to_torch((q, k, v, m, l, acc))]
    out = tops.flash_hop_update(*inputs, *offs, scale, causal=causal)
    got = torch.autograd.grad(out, inputs, grad_outputs=[
        torch.from_numpy(g) for g in (gm, gl, gacc)])
    for name, g, w in zip(("dq", "dk", "dv", "dm", "dl", "dacc"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL, err_msg=f"{case} {name}")
    if case == "ties":     # every row's max is reached exactly twice
        s = (torch.from_numpy(q) @ torch.from_numpy(k).T) * scale
        assert ((s == s.amax(dim=1, keepdim=True)).sum(dim=1) == 2).all()


@pytest.mark.parametrize("causal", [False, True])
def test_plain_hop_gradcheck(causal):
    """The hand-derived backward is the derivative of the plain forward,
    in float64, with two streamed key blocks (one ragged)."""
    rng = np.random.default_rng(4)
    sl, dim = 6, 3
    arrays = [rng.normal(size=(sl, dim)) for _ in range(3)]
    arrays += [rng.normal(size=sl), np.log1p(np.exp(rng.normal(size=sl))),
               rng.normal(size=(sl, dim))]
    inputs = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
              for a in arrays]

    def hop(*t):
        return tops.flash_hop_update(*t, 2, 0, 0.7, causal=causal,
                                     block_k=4)

    assert torch.autograd.gradcheck(hop, inputs)


def test_cuda_wrapper_refuses_what_k5_cannot_take():
    ops = to_torch(hop_case(8, 8, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_hop_update_cuda(*ops, 0, 0, 0.3)
    big = to_torch(hop_case(8, 8, tattn.MAX_DIM + 8, 8))
    with pytest.raises(ValueError, match="up to"):
        tops.flash_hop_update_cuda(*big, 0, 0, 0.3)
    with pytest.raises(TypeError):
        tops.flash_hop_update_cuda(*(t.double() for t in ops), 0, 0, 0.3)
    with pytest.raises(ValueError, match="carry"):
        tops.flash_hop_update(*ops[:3], ops[3][:4], *ops[4:], 0, 0, 0.3)
    with pytest.raises(ValueError, match="0-d"):
        tops.flash_hop_update(*ops, torch.zeros(2), 0, 0.3)


def test_sources_name_every_kernel_source():
    built = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    assert tops.SOURCES == built
    assert {"flash_hop_sm90", "flash_hop_tf32"} <= set(tops.SOURCES)
    assert set(tattn.SOURCES) == set(tattn.ROUTES)


# -- the bf16 route: work list and plain model --------------------------------

# (sl_q, sl_k, q_off, k_off, causal, block_k, n_sm); with more SMs than
# tile pairs every needed key tile is a piece of its own.
SCHEDULE_CASES = {
    "causal": (1000, 1000, 0, 0, True, 128, 132),
    "noncausal-ragged": (300, 777, 0, 0, False, 128, 132),
    "few-sms": (700, 900, 100, 300, True, 64, 7),
    "split-every-tile": (256, 640, 640, 0, True, 128, 132),
    # Keys 512.. lie after every query 0..255: no tile needs a key tile.
    "chunk-after-queries": (256, 300, 0, 512, True, 128, 132),
    # Tile 0 needs none, tile 1 two key tiles; one SM.
    "partly-after": (256, 256, 0, 128, True, 64, 1),
}


@pytest.mark.parametrize("name", sorted(SCHEDULE_CASES))
def test_hop_schedule_covers_every_needed_pair_once(name):
    sl_q, sl_k, qo, ko, causal, bk, n_sm = SCHEDULE_CASES[name]
    sched = tattn.hop_schedule(sl_q, sl_k, qo, ko, causal, bk, n_sm)
    need = tattn.tiles_needed(sl_q, sl_k, qo, ko, causal, bk)
    cap = max(1, -(-sum(need) // n_sm))
    assert len(need) == sched.n_q_tiles == -(-sl_q // 128)
    # Needed pairs from the masks themselves: tile t needs key tile j iff
    # some key of j is at or before some query of t.
    q_pos = qo + np.arange(sl_q)
    k_pos = ko + np.arange(sl_k)
    want = set()
    for t in range(len(need)):
        last = q_pos[t * 128:(t + 1) * 128].max()
        for j in range(-(-sl_k // bk)):
            if not causal or k_pos[j * bk] <= last:
                want.add((t, j))
    got = [(it[0], kt) for it in sched.items for kt in range(it[1], it[2])]
    assert len(got) == len(set(got)) and set(got) == want
    assert sum(sched.loads) == len(want) == sum(need)
    # A tile needing nothing gets one empty item; pieces of a split tile
    # own the consecutive slots slot0 .. slot0 + pieces - 1.
    by_tile = {}
    for it in sched.items:
        by_tile.setdefault(it[0], []).append(it)
    assert sorted(by_tile) == list(range(len(need)))
    slots = []
    for t, its in by_tile.items():
        if need[t] == 0:
            assert [it[1:3] for it in its] == [(0, 0)]
        assert all(it[4] == len(its) for it in its)
        if len(its) > 1:
            assert sorted(it[5] for it in its) == list(
                range(its[0][3], its[0][3] + len(its)))
            slots += [it[5] for it in its]
        else:
            assert its[0][3] == its[0][5] == -1
        assert all(it[2] - it[1] <= cap for it in its)
    assert sorted(slots) == list(range(sched.n_slots))
    # The table is the offsets then the items, CTA by CTA, longest first.
    n = sched.n_cta
    assert n == min(n_sm, len(sched.items))
    offs = sched.table[:n + 1]
    assert offs[0] == 0 and offs[-1] == len(sched.items)
    assert sched.table.dtype == np.int32
    rows = sched.table[n + 1:].reshape(-1, 6)
    assert [tuple(r) for r in rows] == [tuple(it) for it in sched.items]
    for c in range(n):
        lens = [it[2] - it[1] for it in sched.items[offs[c]:offs[c + 1]]]
        assert lens == sorted(lens, reverse=True) and sum(lens) == \
            sched.loads[c]


@pytest.mark.parametrize("causal", [True, False])
def test_hop_schedule_balances_the_bench_shape(causal):
    """S = 8192, 128-row tiles, 132 SMs: the longest CTA load is within 1.5
    times the mean (causal: 2,080 tile pairs, 15.8 per SM)."""
    sched = tattn.hop_schedule(8192, 8192, 0, 0, causal, 128, 132)
    mean = sum(sched.loads) / 132
    assert sched.n_cta == min(132, len(sched.items))
    assert max(sched.loads) <= 1.5 * mean
    assert sum(sched.loads) == (2080 if causal else 4096)


def test_sm90_tiles_and_tma_operands():
    assert tattn.sm90_tiles(128, 128) == (2, 128)
    assert tattn.sm90_tiles(32, 32) == (1, 128)
    assert tattn.sm90_tiles(72, 150) == (3, 64)
    assert tattn.sm90_tiles(256, 8) == (4, 64)
    t = torch.arange(12, dtype=torch.bfloat16).reshape(4, 3)
    padded = tattn._tma_operand(t, 8)
    assert padded.shape == (4, 8) and padded.data_ptr() % 16 == 0
    assert torch.equal(padded[:, :3], t) and not padded[:, 3:].any()
    assert tattn._tma_operand(padded, 8).data_ptr() == padded.data_ptr()


def assert_within_check_hop(got, want, dv):
    """``chip_smoke.check_hop``'s rule: m within 1e-5 max(1, |m|); l, acc
    and the normalized output within 1e-4 of their largest magnitude; the
    bf16 output within one bf16 step at each row's largest magnitude."""
    m_g, l_g, a_g = (t.detach().double().numpy() for t in got)
    m_w, l_w, a_w = (np.asarray(t, np.float64) for t in want)
    assert np.all(np.abs(m_g - m_w) <= 1e-5 * np.maximum(1.0, np.abs(m_w)))
    out_g = a_g / np.maximum(l_g, 1e-30)[:, None]
    out_w = a_w / np.maximum(l_w, 1e-30)[:, None]
    for g, w in ((l_g, l_w), (a_g, a_w), (out_g, out_w)):
        assert np.abs(g - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-30)
    steps = chip_smoke.bf16_steps(torch, torch.from_numpy(out_g).to(
        torch.bfloat16), torch.from_numpy(out_w).to(torch.bfloat16))
    assert steps <= 1.0


# (sl_q, sl_k, D, Dv, causal, (q_off, k_off), carry, masked rows, n_sm);
# 132 SMs and more tile pairs than SMs: query tiles whole; 1000 SMs: every
# key tile a piece of its own, the pieces merged.
SPLIT_CASES = {
    "initial-noncausal": (200, 300, 40, 24, False, (0, 0), "initial", 0,
                          132),
    "mid-causal-split": (256, 384, 32, 32, True, (300, 0), "mid", 16, 1000),
    "few-sms": (300, 500, 48, 40, True, (200, 0), "mid", 0, 3),
    "one-tile-pieces": (100, 520, 64, 64, True, (600, 0), "mid", 8, 1000),
    "wide-64key-tiles": (130, 200, 150, 72, True, (60, 0), "mid", 0, 1000),
    # Rows 0..63 see only keys after them and enter at m = _NEG: they keep
    # l = 0; tile 1 is cut into pieces across the diagonal.
    "masked-rows": (256, 256, 16, 16, True, (0, 64), "mid", 64, 1000),
    # Every key lies after every query: no key tile is read, each tile's
    # one empty item applies m = max(m, _NEG).
    "chunk-after-queries": (128, 200, 16, 16, True, (0, 512), "mid", 64,
                            132),
}


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_reference_matches_jax_kernel(name):
    (sl_q, sl_k, dim, dv, causal, (qo, ko), carry, masked,
     n_sm) = SPLIT_CASES[name]
    ops = hop_case(sl_q, sl_k, dim, dv, seed=len(name), carry=carry,
                   masked_rows=masked)
    scale = 1.0 / np.sqrt(dim)
    want = jattn.flash_hop_update(*to_jax(ops, jnp.bfloat16), qo, ko, scale,
                                  causal=causal, interpret=True)
    got = tattn.flash_hop_update_split_reference(
        *to_torch(ops, torch.bfloat16), qo, ko, scale, causal, n_sm=n_sm)
    assert all(t.dtype == torch.float32 for t in got)
    assert_within_check_hop(got, want, dv)
    sched = tattn.hop_schedule(sl_q, sl_k, qo, ko, causal,
                               tattn.sm90_tiles(dim, dv)[1], n_sm)
    if n_sm == 1000:
        assert sched.n_slots > 0        # partial carries were merged
    if name == "chunk-after-queries":
        assert sched.loads == [0]
    if name in ("masked-rows", "chunk-after-queries"):
        np.testing.assert_array_equal(got[1][:masked].numpy(), 0.0)
        np.testing.assert_array_equal(got[0][:masked].numpy(),
                                      np.float32(NEG))


def test_adam_matches_optax():
    rng = np.random.default_rng(2)
    params = {"w": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    opt_j = optax.adam(0.02, eps_root=1e-9)
    opt_t = adam(0.02, eps_root=1e-9)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    pt = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    sj, st = opt_j.init(pj), opt_t.init(pt)
    for step in range(5):
        grads = {k: rng.normal(size=v.shape).astype(np.float32)
                 for k, v in params.items()}
        uj, sj = opt_j.update({k: jnp.asarray(g) for k, g in grads.items()},
                              sj)
        pj = optax.apply_updates(pj, uj)
        ut, st = opt_t.update({k: torch.from_numpy(g) for k, g in
                               grads.items()}, st)
        pt = apply_updates(pt, ut)
        for k in params:
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"step {step} {k}")
    assert st.count == 5


def test_demo_twin_matches_jax_demo():
    """The first 3 losses of the demo twin against the JAX demo's loss_fn
    and step (``ring_attention(flash=False)`` on a one-device mesh), from
    the JAX demo's own initial weights."""
    from gossipy_tpu.parallel import make_mesh
    from gossipy_tpu.parallel.collectives import ring_attention

    s_len, dim, seed, steps = 32, 16, 42, 3
    x_np, tgt_np, _ = demo.make_task(s_len, dim, seed)
    mesh = make_mesh(1)
    x, tgt = jnp.asarray(x_np), jnp.asarray(tgt_np)
    kq, kk, kv = jax.random.split(jax.random.PRNGKey(seed), 3)
    scale = 1.0 / np.sqrt(dim)
    params = {"wq": jax.random.normal(kq, (dim, dim)) * scale,
              "wk": jax.random.normal(kk, (dim, dim)) * scale,
              "wv": jax.random.normal(kv, (dim, dim)) * scale}
    opt = optax.adam(0.02)
    opt_state = opt.init(params)

    def loss_fn(p):
        out = ring_attention(x @ p["wq"], x @ p["wk"], x @ p["wv"], mesh,
                             flash=False)
        return jnp.mean((out - tgt) ** 2)

    start = {k: np.asarray(v) for k, v in params.items()}
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    want = []
    for _ in range(steps):
        loss, grads = grad_fn(params)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        want.append(float(loss))

    got, _ = demo.train(demo.params_from_numpy(start, "cpu"),
                        torch.from_numpy(x_np), torch.from_numpy(tgt_np),
                        steps)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_demo_runs_on_cpu_and_refuses_a_ring():
    rec = demo.run(seq_len=32, dim=8, steps=3, seed=1, device="cpu")
    assert rec["devices"] == 1 and rec["seq_len"] == 32
    assert np.isfinite(rec["loss_first"]) and np.isfinite(rec["loss_last"])
    ring = demo.run(seq_len=32, dim=8, steps=3, seed=1, devices=2,
                    device="cpu")
    assert ring["devices"] == 2 and ring["per_device_kv_rows"] == 16
    assert ring["loss_first"] == pytest.approx(rec["loss_first"], abs=1e-4)
    with pytest.raises(ValueError, match="divide"):
        demo.run(seq_len=32, dim=8, steps=1, devices=3, device="cpu")
