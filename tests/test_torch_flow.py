"""The token accounts, model partitions, sampled merges and the three
subset and weighted SGD handlers against the JAX package's.

- Each token account's ``proactive`` and ``reactive`` on balances 0..40
  and utilities 0 and 1, equal to the JAX policy's; the randomised
  rounding fed the JAX ``uniform(key)`` draw its ``bernoulli(key, p)``
  makes; the JAX assertions as ``ValueError``.
- ``ModelPartition``: each column's part id equal to the JAX partition's
  in flat leaf order (LogReg and CIFAR10Net), padding columns in none;
  the weighted one-part merge within 1e-6, padding untouched.
- The sampled merge's mask: the draw oracle's is the JAX
  ``sample_mask(fold_in(PRNGKey(0x5A11), payload))`` mask; the port's
  hash mask is a function of the payload alone, samples about
  ``sample_size`` of the real columns and never a padding column.
- ``WeightedSGDHandler.merge_many``, ``SamplingSGDHandler`` and
  ``PartitionedSGDHandler`` (``merge``, ``update``, ``call`` in UPDATE
  and MERGE_UPDATE) over 4 nodes against the vmapped JAX handler under
  the same keys and masks: params within 1e-5, ages exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gossipy_tpu import flow_control as jflow
from gossipy_tpu.compression import ModelPartition as JModelPartition
from gossipy_tpu.compression import sample_mask as jsample_mask
from gossipy_tpu.compression import sampled_merge as jsampled_merge
from gossipy_tpu.core import CreateModelMode
from gossipy_tpu.handlers import PartitionedSGDHandler, SamplingSGDHandler, \
    WeightedSGDHandler, losses
from gossipy_tpu.handlers.base import ModelState as JModelState
from gossipy_tpu.handlers.base import PeerModel as JPeerModel
from gossipy_tpu.models import CIFAR10Net, LogisticRegression
from gossipy_tpu_torch import convert
from gossipy_tpu_torch import flow_control as tflow
from gossipy_tpu_torch import handlers as th
from gossipy_tpu_torch.compression import ModelPartition, sample_mask, \
    sampled_merge
from gossipy_tpu_torch.models import CIFAR10Net as TCIFAR10Net
from gossipy_tpu_torch.models import LogisticRegression as TLogReg
from gossipy_tpu_torch.models.nn import ParamLayout
from gossipy_tpu_torch.optim import add_decayed_weights, chain, sgd
from torch_oracle import JaxDraws, perms_from_keys

torch.set_num_threads(1)

D, S, N = 6, 10, 4

ACCOUNTS = [tflow.PurelyProactiveTokenAccount(),
            tflow.PurelyReactiveTokenAccount(k=2),
            tflow.SimpleTokenAccount(C=3),
            tflow.GeneralizedTokenAccount(C=20, A=10),
            tflow.RandomizedTokenAccount(C=20, A=10),
            tflow.RandomizedTokenAccount(C=4, A=3)]


@pytest.mark.parametrize("acc", ACCOUNTS, ids=repr)
def test_token_account_matches_jax(acc):
    jacc = getattr(jflow, type(acc).__name__)(**dataclasses.asdict(acc))
    balance = np.arange(41, dtype=np.int32)
    tb = torch.from_numpy(balance)
    np.testing.assert_array_equal(
        acc.proactive(tb).numpy(), np.asarray(jacc.proactive(
            jnp.asarray(balance))))
    assert acc.proactive(tb).dtype == torch.float32
    key = jax.random.PRNGKey(3)
    u = torch.from_numpy(np.array(jax.random.uniform(key, balance.shape)))
    for util in (0.0, 1.0):
        ut = np.full(balance.shape, util, np.float32)
        got = acc.reactive(tb, torch.from_numpy(ut), u)
        want = jacc.reactive(jnp.asarray(balance), jnp.asarray(ut), key)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert acc.init_balance(5).dtype == torch.int32
    assert acc.draws_reactive == isinstance(acc, tflow.RandomizedTokenAccount)


def test_token_account_assertions_raise():
    for bad in (dict(C=0), ):
        with pytest.raises(ValueError):
            tflow.SimpleTokenAccount(**bad)
    for bad in (dict(C=0, A=1), dict(C=3, A=0), dict(C=3, A=4)):
        with pytest.raises(ValueError):
            tflow.GeneralizedTokenAccount(**bad)
        with pytest.raises(ValueError):
            tflow.RandomizedTokenAccount(**bad)


@functools.lru_cache(maxsize=None)
def templates():
    lr = LogisticRegression(D, 2).init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, D)))["params"]
    cnn = CIFAR10Net().init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))["params"]
    return {"logreg": (lr, ParamLayout(TLogReg(D, 2).leaves)),
            "cifar": (cnn, ParamLayout(TCIFAR10Net().leaves))}


@pytest.mark.parametrize("model", ["logreg", "cifar"])
@pytest.mark.parametrize("parts", [3, 4])
def test_partition_matches_jax(model, parts):
    template, layout = templates()[model]
    jp = JModelPartition(template, parts)
    tp = ModelPartition(layout, parts)
    assert tp.n_parts == jp.n_parts
    np.testing.assert_array_equal(tp.sizes, jp.sizes)
    ids = convert.params_from_jax(jax.tree.map(np.asarray, jp.part_ids),
                                  layout, stacked=False)
    real = torch.arange(layout.stride) < layout.width
    np.testing.assert_array_equal(tp.part_of[real].numpy(),
                                  ids[real].long().numpy())
    assert (tp.part_of[~real] == -1).all()


@pytest.mark.parametrize("ages", [(3, 5), (0, 0), (7, 0)])
def test_partition_merge_matches_jax(ages):
    template, layout = templates()["logreg"]
    jp, tp = JModelPartition(template, 3), ModelPartition(layout, 3)
    rng = np.random.default_rng(1)
    a = jax.tree.map(lambda l: rng.normal(size=l.shape).astype(np.float32),
                     template)
    b = jax.tree.map(lambda l: rng.normal(size=l.shape).astype(np.float32),
                     template)
    for pid in range(3):
        want = jp.merge(a, b, pid, weights=(jnp.int32(ages[0]),
                                            jnp.int32(ages[1])))
        ta = convert.params_from_jax(a, layout, stacked=False)[None]
        tb = convert.params_from_jax(b, layout, stacked=False)[None]
        ta[0, layout.width:] = 9.0   # padding: never merged
        got = tp.merge(ta, tb, torch.tensor([pid + 3]),
                       weights=(torch.tensor([ages[0]]),
                                torch.tensor([ages[1]])))
        wt = convert.params_from_jax(jax.tree.map(np.asarray, want), layout,
                                     stacked=False)
        np.testing.assert_allclose(got[0, :layout.width].numpy(),
                                   wt[:layout.width].numpy(), atol=1e-6)
        assert (got[0, layout.width:] == 9.0).all()


def test_oracle_mask_is_the_jax_mask():
    template, layout = templates()["logreg"]
    payload = torch.tensor([0, 5, 2 ** 31 - 2], dtype=torch.int32)
    got = JaxDraws(jax.random.PRNGKey(0)).sample_mask(payload, layout, 0.3)
    base = jax.random.PRNGKey(JaxDraws.SAMPLE_KEY)
    for i, e in enumerate(payload.tolist()):
        want = jsample_mask(jax.random.fold_in(base, e), template, 0.3)
        wt = convert.params_from_jax(
            jax.tree.map(lambda m: np.asarray(m, np.float32), want), layout,
            stacked=False)
        np.testing.assert_array_equal(got[i].numpy(), wt.numpy() > 0)


def test_port_mask_is_a_function_of_the_payload():
    layout = ParamLayout(TLogReg(D, 2).leaves)    # width 14, stride 16
    payload = torch.arange(4000, dtype=torch.int32) * 7919
    m = sample_mask(payload, layout, 0.25)
    assert m.shape == (4000, layout.stride) and m.dtype == torch.bool
    assert not m[:, layout.width:].any()
    frac = m[:, :layout.width].float().mean().item()
    assert abs(frac - 0.25) < 0.01
    assert torch.equal(sample_mask(payload.flip(0), layout, 0.25),
                       m.flip(0))
    # Distinct payloads give distinct masks (almost surely).
    assert len({tuple(r) for r in m[:200].tolist()}) > 190
    p1, p2 = torch.randn(4000, layout.stride), torch.randn(4000,
                                                           layout.stride)
    out = sampled_merge(p1, p2, m)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jsampled_merge(p1.numpy(), p2.numpy(),
                                               m.numpy())))


def shards():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(N, S, D)).astype(np.float32)
    y = rng.integers(0, 2, (N, S))
    mask = np.ones((N, S), np.float32)
    mask[3, 4:] = 0.0
    return X, y, mask


def handler_pair(kind, mode):
    common = dict(local_epochs=2, batch_size=4, n_classes=2,
                  input_shape=(D,), create_model_mode=mode)
    jcommon = dict(model=LogisticRegression(D, 2), loss=losses.cross_entropy,
                   optimizer=optax.chain(optax.add_decayed_weights(1e-3),
                                         optax.sgd(0.5)), **common)
    tcommon = dict(loss=th.losses.cross_entropy,
                   optimizer=chain(add_decayed_weights(1e-3), sgd(0.5)),
                   **common)
    template, layout = templates()["logreg"]
    if kind == "sampling":
        return (SamplingSGDHandler(0.4, **jcommon),
                th.SamplingSGDHandler(0.4, TLogReg(D, 2), **tcommon))
    if kind == "partitioned":
        return (PartitionedSGDHandler(JModelPartition(template, 3),
                                      **jcommon),
                th.PartitionedSGDHandler(ModelPartition(layout, 3),
                                         TLogReg(D, 2), **tcommon))
    return (WeightedSGDHandler(**jcommon),
            th.WeightedSGDHandler(TLogReg(D, 2), **tcommon))


def states(jh, th_, seed):
    jst = jax.vmap(jh.init)(jax.random.split(jax.random.PRNGKey(seed), N))
    if jst.n_updates.ndim == 2:
        ages = np.arange(N * jst.n_updates.shape[1], dtype=np.int32).reshape(
            jst.n_updates.shape) % 5
    else:
        ages = np.arange(N, dtype=np.int32) * 2
    jst = JModelState(jst.params, jst.opt_state, jnp.asarray(ages))
    layout = th_.layout
    tst = th.ModelState(
        convert.params_from_jax(jax.tree.map(np.asarray, jst.params),
                                layout),
        convert.opt_state_from_jax(jax.tree.map(np.asarray, jst.opt_state),
                                   layout, th_.optimizer),
        torch.from_numpy(ages))
    return jst, tst


def assert_params(th_, got, want, tol=1e-5):
    wt = convert.params_from_jax(jax.tree.map(np.asarray, want.params),
                                 th_.layout)
    np.testing.assert_allclose(got.params.numpy(), wt.numpy(), atol=tol)
    np.testing.assert_array_equal(got.n_updates.numpy(),
                                  np.asarray(want.n_updates))


def test_weighted_merge_many_matches_jax():
    jh, th_ = handler_pair("weighted", CreateModelMode.MERGE_UPDATE)
    jst, tst = states(jh, th_, 1)
    K = 3
    rng = np.random.default_rng(2)
    peers = [states(jh, th_, 10 + k) for k in range(K)]
    weights = rng.uniform(0.1, 1.0, (N, K + 1)).astype(np.float32)
    valid = (rng.uniform(size=(N, K)) > 0.3).astype(np.float32)
    valid[0] = 0.0   # a node with no valid peer keeps its own model
    ages = rng.integers(0, 9, (N, K)).astype(np.int32)
    jpeers = jax.tree.map(lambda *ls: jnp.stack(ls, axis=1),
                          *[p[0].params for p in peers])
    want = jax.vmap(jh.merge_many)(jst, jpeers, jnp.asarray(weights),
                                   jnp.asarray(ages), jnp.asarray(valid))
    got = th_.merge_many(tst, torch.stack([p[1].params for p in peers], 1),
                         torch.from_numpy(weights), torch.from_numpy(ages),
                         torch.from_numpy(valid))
    assert_params(th_, got, want, tol=1e-6)


def test_subset_handlers_keep_the_plain_path():
    for kind in ("sampling", "partitioned"):
        _, th_ = handler_pair(kind, CreateModelMode.UPDATE)
        assert th_.uniform_avg_merge is False
    _, th_ = handler_pair("weighted", CreateModelMode.MERGE_UPDATE)
    assert th_.uniform_avg_merge is True and th_.merge_peer_weight == 0.5
    template, layout = templates()["logreg"]
    common = dict(create_model_mode=CreateModelMode.PASS)
    with pytest.raises(ValueError):
        th.SamplingSGDHandler(0.4, TLogReg(D, 2), th.losses.cross_entropy,
                              **common)
    with pytest.raises(ValueError):
        th.PartitionedSGDHandler(ModelPartition(layout, 3), TLogReg(D, 2),
                                 th.losses.cross_entropy, **common)


@pytest.mark.parametrize("mode", [CreateModelMode.UPDATE,
                                  CreateModelMode.MERGE_UPDATE])
@pytest.mark.parametrize("kind", ["sampling", "partitioned"])
def test_subset_call_matches_jax(kind, mode):
    """The receive dispatch: UPDATE trains the received model and merges
    its subset into the node's own; MERGE_UPDATE merges, then trains."""
    jh, th_ = handler_pair(kind, mode)
    jst, tst = states(jh, th_, 1)
    jpeer, tpeer = states(jh, th_, 2)
    X, y, mask = shards()
    keys = jax.random.split(jax.random.PRNGKey(9), N)
    if kind == "sampling":
        base = jax.random.PRNGKey(JaxDraws.SAMPLE_KEY)
        payload = torch.tensor([1, 22, 333, 4444], dtype=torch.int32)
        jextra = jax.vmap(lambda e: jax.random.fold_in(base, e))(
            jnp.asarray(payload.numpy()))
        textra = JaxDraws(base).sample_mask(payload, th_.layout, 0.4)
    else:
        jextra = jnp.asarray([0, 1, 2, 5], jnp.int32)
        textra = torch.tensor([0, 1, 2, 5], dtype=torch.int32)
    want = jax.vmap(jh.call)(jst, JPeerModel(jpeer.params, jpeer.n_updates),
                             (jnp.asarray(X), jnp.asarray(y),
                              jnp.asarray(mask)), keys, jextra)
    perms = torch.from_numpy(perms_from_keys(keys, 2, S)).long()
    got = th_.call(tst, th.PeerModel(tpeer.params, tpeer.n_updates),
                   (torch.from_numpy(X), torch.from_numpy(y),
                    torch.from_numpy(mask)), perms, textra)
    assert_params(th_, got, want)
    if kind == "sampling" and mode == CreateModelMode.UPDATE:
        # The merge does not advance the node's age.
        assert torch.equal(got.n_updates, tst.n_updates)


def test_partitioned_update_ages_every_part():
    jh, th_ = handler_pair("partitioned", CreateModelMode.UPDATE)
    jst, tst = states(jh, th_, 1)
    X, y, mask = shards()
    keys = jax.random.split(jax.random.PRNGKey(4), N)
    want = jax.vmap(jh.update)(jst, (jnp.asarray(X), jnp.asarray(y),
                                     jnp.asarray(mask)), keys)
    perms = torch.from_numpy(perms_from_keys(keys, 2, S)).long()
    got = th_.update(tst, (torch.from_numpy(X), torch.from_numpy(y),
                           torch.from_numpy(mask)), perms)
    assert_params(th_, got, want)
    # Every part ages by one a step: 3 batches in each of 2 epochs on a
    # full shard, fewer where a batch holds no real row.
    steps = (got.n_updates - tst.n_updates).numpy()
    assert (steps == steps[:, :1]).all() and (steps[:3] == 6).all()
    assert 0 < steps[3, 0] < 6
    one = th_.init(torch.Generator().manual_seed(0), "cpu")
    assert one.n_updates.shape == (3,) and one.n_updates.dtype == torch.int32
