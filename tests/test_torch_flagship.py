"""The 100-node CIFAR-10 flagship (``examples/main_cifar10_100nodes.py``)
in both engines, cut to 8 nodes and a few hundred images, under the JAX
draw oracle.

The port side is built by its twin's own functions
(``gossipy_tpu_torch.examples.main_cifar10_100nodes``): the normalisation
by the training statistics, the Dirichlet label skew (beta 0.5, assigned
with the run's seed), CIFAR10Net at its full width (73,418 params) under
weight decay 1e-3 and SGD 0.05, batch 32, MERGE_UPDATE, PUSH on
``random_regular(8, 7, seed=42)``, a 10% sampled evaluation, a common
initialisation. Both engines start from the JAX ``init_nodes`` state and
run 2 rounds: the per-round accounting, both boxes, the ages and the
ring's ages are equal exactly.

The params are held by a rule, not by one elementwise bound. A step of
the two frameworks differs by rounding (``test_torch_handlers.py`` holds
the flagship's update within 1e-5), but at CIFAR10Net's width a step has
millions of ReLU and max-pool decisions, and a pre-activation within
rounding of 0 (or two pool inputs within rounding of each other) goes one
way in one framework and the other way in the other: that node's step
then differs by a whole gradient term, and the merges carry it to its
neighbours. (A float64 run of the same update differs from both float32
runs in the same way.) So:

- fp32: the median element within 1e-6 (the bulk agrees to rounding: a
  systematic fault, such as a missing or doubled decay term, moves every
  element), and the largest within half of what bf16 compute moves the
  same run (the port's bf16 against its fp32 run on the same draws);
- bf16: each framework's bf16 run is its own perturbation of the same
  fp32 run (rounding in other places, other decisions flipped), so the
  two lie within twice bf16's own effect of each other (the triangle
  inequality): the port's bf16 run against the JAX one, in the largest
  and in the median element, beside the distance from the JAX bf16 run
  to the port's fp32 run; and the port's bf16 run must itself move at
  least half that far from its fp32 run (bf16 was applied).
  ``test_torch_handlers.py`` holds one bf16 update tighter.

Two JAX programs are built (multi in fp32, plain in bf16), the slowest
part of the file (~40 s on one core).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gossipy_tpu import core as jcore
from gossipy_tpu.data import AssignmentHandler, ClassificationDataHandler, \
    DataDispatcher, _synthetic_images
from gossipy_tpu.handlers import SGDHandler, losses
from gossipy_tpu.models import CIFAR10Net
from gossipy_tpu.simulation import GossipSimulator
from gossipy_tpu_torch.convert import flatten_names, params_to_numpy
from gossipy_tpu_torch.examples import main_cifar10_100nodes as flag
from torch_oracle import JaxDraws
from torch_pairs import assert_same_accounting, to_port_state

torch.set_num_threads(1)

N, ROUNDS, SEED = 8, 2, 42


def sets():
    return (_synthetic_images("cifar10-train", 320, (32, 32, 3), 10),
            _synthetic_images("cifar10-test", 64, (32, 32, 3), 10))


def jax_stacked():
    """The JAX example's data steps on the same images."""
    (Xtr, ytr), (Xte, yte) = sets()
    mu, sd = Xtr.mean(), Xtr.std() + 1e-8
    disp = DataDispatcher(
        ClassificationDataHandler((Xtr - mu) / sd, ytr, (Xte - mu) / sd, yte),
        n=N, eval_on_user=False,
        assignment=AssignmentHandler.label_dirichlet_skew, beta=0.5)
    disp.assign(SEED)
    return disp.stacked()


def jax_sim(stacked, deliver, bf16):
    handler = SGDHandler(
        model=CIFAR10Net(), loss=losses.cross_entropy,
        optimizer=optax.chain(optax.add_decayed_weights(1e-3),
                              optax.sgd(0.05)),
        local_epochs=1, batch_size=32, n_classes=10, input_shape=(32, 32, 3),
        create_model_mode=jcore.CreateModelMode.MERGE_UPDATE,
        compute_dtype=jnp.bfloat16 if bf16 else None)
    return GossipSimulator(
        handler, jcore.Topology.random_regular(N, N - 1, seed=42,
                                               backend="networkx"),
        stacked, delta=100, protocol=jcore.AntiEntropyProtocol.PUSH,
        sampling_eval=0.1, sync=True, fused_merge=flag.DELIVER[deliver])


def port_run(stacked, deliver, bf16, key, jst0):
    """The twin's simulator from the JAX initial state, under the oracle."""
    tsim = flag.flagship_sim(stacked, N, bf16, deliver,
                             draws=JaxDraws(key, init_key=key), device="cpu")
    tst, trep = tsim.start(to_port_state(tsim, jst0), n_rounds=ROUNDS)
    return tsim, tst, trep


def flat_port(tsim, tst):
    views = params_to_numpy(tst.model.params, tsim.handler.layout)
    return np.concatenate([views[k].ravel() for k in sorted(views)])


def flat_jax(jst):
    return np.concatenate([np.asarray(v).ravel() for _, v in
                           sorted(flatten_names(jst.model.params).items())])


@pytest.mark.parametrize("deliver,bf16", [("multi", False),
                                          ("plain", True)])
def test_flagship_matches_jax_engine(deliver, bf16):
    stacked = flag.flagship_data(N, seed=SEED, sets=sets())
    want = jax_stacked()
    assert sorted(stacked) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(stacked[k], want[k], err_msg=k)
    key = jax.random.PRNGKey(SEED)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore",
                                message=r"mailbox_slots=\d+ may overflow")
        jsim = jax_sim(stacked, deliver, bf16)
        jst0 = jsim.init_nodes(key, common_init=True)
        jst, jrep = jsim.start(jst0, n_rounds=ROUNDS, key=key,
                               donate_state=False)
        tsim, tst, trep = port_run(stacked, deliver, bf16, key, jst0)
        other, ost, _ = port_run(stacked, deliver, not bf16, key, jst0)
    assert_same_accounting(jsim, tsim, jst, tst, jrep, trep)
    assert (trep.wide_slots_per_round + trep.compact_slots_per_round).all()
    assert np.isfinite(trep.final("accuracy"))
    got, ref = flat_port(tsim, tst), flat_jax(jst)
    assert np.isfinite(got).all()
    if bf16:
        fp32 = flat_port(other, ost)
        diff, effect = np.abs(got - ref), np.abs(ref - fp32)
        assert diff.max() <= 2 * effect.max(), (diff.max(), effect.max())
        assert np.median(diff) <= 2 * np.median(effect), \
            (np.median(diff), np.median(effect))
        assert np.median(np.abs(got - fp32)) >= 0.5 * np.median(effect)
    else:
        diff = np.abs(got - ref)
        effect = np.abs(flat_port(other, ost) - got)
        assert np.median(diff) <= 1e-6, np.median(diff)
        assert diff.max() <= 0.5 * effect.max(), (diff.max(), effect.max())
