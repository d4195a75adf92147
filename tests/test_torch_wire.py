"""The port's history-ring wire formats against the JAX package's.

Over the port's flat row, an int8 ring keeps one float32 scale per (ring
cell, node, leaf), where the JAX package keeps one per row of each leaf of
a pytree: the same numbers in another layout. The first encode of the same
float32 input is held bit for bit (int8 codes and scales, bfloat16 bits),
including an all-zero leaf and leaves whose edges fall inside a 4-column
word; the decode and the message size exactly.
"""

import types
import warnings

import jax
import numpy as np
import optax
import pytest
import torch

from gossipy_tpu.core import Topology
from gossipy_tpu.handlers import SGDHandler, losses
from gossipy_tpu.models import LogisticRegression
from gossipy_tpu.simulation import GossipSimulator
from gossipy_tpu_torch import convert
from gossipy_tpu_torch import core as tcore
from gossipy_tpu_torch.handlers import ModelState as TModelState
from gossipy_tpu_torch.handlers import SGDHandler as TSGDHandler
from gossipy_tpu_torch.handlers import losses as tlosses
from gossipy_tpu_torch.models import LogisticRegression as TLogReg
from gossipy_tpu_torch.simulation import GossipSimulator as TGossipSimulator

torch.set_num_threads(1)

N = 5
# Leaf widths 6, 1, 7, 24 and 12 put leaf edges at columns 12, 18, 19 and
# 31, inside 4-column words; "C/bias" is all zero.
SHAPES = {"A/bias": (6,), "A/kernel": (2, 3, 2), "B/bias": (1,),
          "B/kernel": (7,), "C/bias": (12,)}


class TreeModel:
    """A stand-in model that only names its leaves (the engine's codec
    reads the layout, nothing else)."""

    def __init__(self, shapes):
        self.leaves = sorted(shapes.items())


def port_sim(history_dtype, shapes=SHAPES, n=N):
    h = TSGDHandler(TreeModel(shapes), tlosses.cross_entropy,
                    input_shape=(2,))
    data = {"xtr": np.zeros((n, 1, 2), np.float32),
            "ytr": np.zeros((n, 1), np.int64),
            "mtr": np.ones((n, 1), np.float32)}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return TGossipSimulator(h, tcore.Topology.clique(n), data,
                                mailbox_slots=2, history_dtype=history_dtype,
                                fused_merge=False, device="cpu")


def jax_tree(seed=0, n=N):
    """A stacked tree ``{"A": {"bias": [n, 6], ...}}`` of float32 values,
    with ``C/bias`` all zero and a few values on int8 rounding midpoints."""
    rng = np.random.default_rng(seed)
    tree = {}
    for name, shape in SHAPES.items():
        top, leaf = name.split("/")
        v = rng.normal(scale=0.3, size=(n,) + shape).astype(np.float32)
        if name == "C/bias":
            v[:] = 0.0
        tree.setdefault(top, {})[leaf] = v
    # Exact halves of the quantum: round-half-to-even decides them.
    k = tree["A"]["kernel"]
    k[:, 0, 0, 0] = 1.0
    k[:, 0, 0, 1] = 2.5 / 127.0
    k[:, 0, 1, 0] = -3.5 / 127.0
    return tree


def jax_encode(history_dtype, tree):
    # _encode_history_rows reads nothing of the simulator but this field.
    this = types.SimpleNamespace(history_dtype=history_dtype)
    stored, scales = GossipSimulator._encode_history_rows(this, tree)
    return stored, scales, this


def leaf_views(sim, flat):
    return sim.handler.layout.views(flat)


@pytest.mark.parametrize("history_dtype", ["float32", "bfloat16", "int8"])
def test_encode_matches_jax_bit_for_bit(history_dtype):
    tree = jax_tree()
    sim = port_sim(history_dtype)
    flat = convert.params_from_jax(tree, sim.handler.layout)
    stored, scales = sim._encode_history_rows(flat)
    want, want_scales, _ = jax_encode(history_dtype, tree)
    assert stored.dtype == sim._HISTORY_DTYPES[history_dtype]
    assert (scales is None) == (history_dtype != "int8")
    views = leaf_views(sim, stored)
    for i, (name, _) in enumerate(sim.handler.layout.leaves):
        top, leaf = name.split("/")
        w = np.asarray(want[top][leaf])
        got = views[name]
        if history_dtype == "bfloat16":
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          w.view(np.int16), err_msg=name)
        else:
            np.testing.assert_array_equal(got.numpy(), w, err_msg=name)
        if history_dtype == "int8":
            np.testing.assert_array_equal(
                scales[:, i].numpy(), np.asarray(want_scales[top][leaf]),
                err_msg=name)
    # Padding columns encode to 0.
    assert (stored[:, sim.handler.layout.width:].to(torch.float32)
            == 0).all()


def test_int8_zero_leaf_scale_is_one_and_codes_zero():
    sim = port_sim("int8")
    flat = convert.params_from_jax(jax_tree(), sim.handler.layout)
    stored, scales = sim._encode_history_rows(flat)
    c = [name for name, _ in sim.handler.layout.leaves].index("C/bias")
    assert (scales[:, c] == 1.0).all()
    assert (leaf_views(sim, stored)["C/bias"] == 0).all()


@pytest.mark.parametrize("history_dtype", ["float32", "bfloat16", "int8"])
def test_roundtrip_matches_jax_decode(history_dtype):
    tree = jax_tree(seed=3)
    sim = port_sim(history_dtype)
    flat = convert.params_from_jax(tree, sim.handler.layout)
    got = convert.params_to_numpy(sim._wire_roundtrip(flat),
                                  sim.handler.layout)
    stored, scales, this = jax_encode(history_dtype, tree)
    want = GossipSimulator._decode_history_rows(this, stored, scales)
    for name in got:
        top, leaf = name.split("/")
        np.testing.assert_array_equal(got[name], np.asarray(want[top][leaf]),
                                      err_msg=name)


def test_int8_roundtrip_within_half_a_quantum():
    sim = port_sim("int8")
    flat = convert.params_from_jax(jax_tree(seed=4), sim.handler.layout)
    _, scales = sim._encode_history_rows(flat)
    err = (sim._wire_roundtrip(flat) - flat).abs()
    bound = 0.5 * scales[:, sim._col_leaf] * (1 + 1e-6)
    assert (err <= bound).all()


@pytest.mark.parametrize("history_dtype", ["float32", "bfloat16", "int8"])
def test_ring_and_message_size_match_jax(history_dtype):
    n, d = 6, 4
    rng = np.random.default_rng(2)
    data = {"xtr": rng.normal(size=(n, 3, d)).astype(np.float32),
            "ytr": rng.integers(0, 2, (n, 3)),
            "mtr": np.ones((n, 3), np.float32)}
    jh = SGDHandler(model=LogisticRegression(d, 2), loss=losses.cross_entropy,
                    optimizer=optax.sgd(0.1), n_classes=2, input_shape=(d,))
    th = TSGDHandler(TLogReg(d, 2), tlosses.cross_entropy, n_classes=2,
                     input_shape=(d,))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsim = GossipSimulator(jh, Topology.clique(n), data, mailbox_slots=2,
                               history_dtype=history_dtype)
        tsim = TGossipSimulator(th, tcore.Topology.clique(n), data,
                                mailbox_slots=2, history_dtype=history_dtype,
                                device="cpu")
    assert tsim.wire_bytes_per_message() == jsim.wire_bytes_per_message()
    assert tsim._wire_itemsize() == jsim._wire_itemsize()
    key = jax.random.PRNGKey(0)
    jst = jsim.init_nodes(key, local_train=False)
    params = convert.params_from_jax(jax.tree.map(np.asarray,
                                                  jst.model.params),
                                     th.layout)
    tst = tsim.init_state(
        TModelState(params, (), torch.zeros(n, dtype=torch.int32)),
        torch.zeros(n, dtype=torch.int32))
    D = jst.history_ages.shape[0]
    assert tst.history_params.shape == (D, n, th.layout.stride)
    assert tst.history_params.dtype == tsim._HISTORY_DTYPES[history_dtype]
    ring = convert.params_to_numpy(tst.history_params.to(torch.float32),
                                   th.layout)
    for leaf in ("bias", "kernel"):
        want = np.asarray(jst.history_params["Dense_0"][leaf]
                          ).astype(np.float32)
        np.testing.assert_array_equal(ring[f"Dense_0/{leaf}"], want)
    if history_dtype == "int8":
        assert tst.history_scale.shape == (D, n, 2)
        for i, leaf in enumerate(("bias", "kernel")):
            np.testing.assert_array_equal(
                tst.history_scale[..., i].numpy(),
                np.asarray(jst.history_scale["Dense_0"][leaf]))
    else:
        assert tst.history_scale is None
    # The snapshot re-encodes the round-start params into cell r % D.
    tst.model = TModelState(tst.model.params * 2.0, (),
                            tst.model.n_updates + 1)
    tsim._snapshot(tst, 1)
    stored, scales = tsim._encode_history_rows(tst.model.params)
    assert torch.equal(tst.history_params[1], stored)
    assert (tst.history_ages[1] == 1).all()
    if scales is not None:
        assert torch.equal(tst.history_scale[1], scales)


def test_unknown_history_dtype_rejected():
    with pytest.raises(ValueError, match="history_dtype"):
        port_sim("float16")
