"""Onoszko 2021 (PENS on CIFAR-10) in both engines, cut to 3 nodes and 48
training images, under the JAX draw oracle.

The port side is built by its twin
(``gossipy_tpu_torch/examples/main_onoszko_2021.py``): the CIFAR-10
stand-in normalised, the second halves flipped vertically, contiguous
blocks over the nodes, CIFAR10Net at its full width under weight decay
1e-3 and SGD 0.01, batch 8, 3 local epochs, PENS with ``n_sampled = 2``
and ``m_top = 2`` on a clique, async PUSH; the JAX side by the JAX
package's classes on the same arrays. Both start from the JAX
``init_nodes`` state and run 5 rounds, 3 of them in phase 1, so that the
phase-1 flush, the phase switch and phase-2 gossip all run. Accounting,
boxes, ages and the integer ``aux`` (selection counters, buffer senders
and counts, the best neighbours) exactly; the params by the
decision-flip rule of ``test_torch_flagship.py`` (PERF.md §2): the
median element within 1e-6 and the largest within half of what bf16
compute moves the port's same run.
"""

import warnings

import jax
import numpy as np
import optax
import torch

from gossipy_tpu import core as jcore
from gossipy_tpu import data as jdata
from gossipy_tpu.core import CreateModelMode
from gossipy_tpu.handlers import SGDHandler, losses
from gossipy_tpu.models import CIFAR10Net
from gossipy_tpu.simulation import PENSGossipSimulator
from gossipy_tpu_torch.convert import flatten_names, params_to_numpy
from gossipy_tpu_torch.examples import main_onoszko_2021 as onoszko
from torch_oracle import JaxDraws
from torch_pairs import assert_same_accounting, to_port_state

torch.set_num_threads(1)

N, IMAGES, STEP1, ROUNDS, SEED = 3, 48, 3, 5, 42


def sets():
    return (jdata._synthetic_images("cifar10-train", IMAGES, (32, 32, 3),
                                    10),
            jdata._synthetic_images("cifar10-test", 15, (32, 32, 3), 10))


def jax_stacked():
    """The JAX example's data steps (main_onoszko_2021.py) on the same
    images."""
    (Xtr, ytr), (Xte, yte) = sets()
    Xte, yte = Xte[:IMAGES // 5], yte[:IMAGES // 5]
    Xtr = (Xtr - Xtr.mean()) / (Xtr.std() + 1e-8)
    Xte = (Xte - Xte.mean()) / (Xte.std() + 1e-8)
    half, half_te = len(Xtr) // 2, len(Xte) // 2
    Xtr[half:] = Xtr[half:, ::-1, :, :]
    Xte[half_te:] = Xte[half_te:, ::-1, :, :]
    disp = jdata.DataDispatcher(jdata.ClassificationDataHandler(
        Xtr, ytr, Xte, yte), n=N, eval_on_user=False, auto_assign=False)
    disp.set_assignments(onoszko.contiguous_assignment(len(Xtr), N))
    return disp.stacked()


def flat(views):
    return np.concatenate([np.asarray(views[k]).ravel()
                           for k in sorted(views)])


def test_onoszko_matches_jax_engine():
    stacked = onoszko.onoszko_data(N, IMAGES, sets=sets())
    want = jax_stacked()
    assert sorted(stacked) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(stacked[k], want[k], err_msg=k)
    key = jax.random.PRNGKey(SEED)
    handler = SGDHandler(
        model=CIFAR10Net(), loss=losses.cross_entropy,
        optimizer=optax.chain(optax.add_decayed_weights(1e-3),
                              optax.sgd(0.01)),
        local_epochs=3, batch_size=8, n_classes=10, input_shape=(32, 32, 3),
        create_model_mode=CreateModelMode.MERGE_UPDATE)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=r"mailbox_slots=")
        jsim = PENSGossipSimulator(
            handler, jcore.Topology.clique(N), stacked, n_sampled=N - 1,
            m_top=2, step1_rounds=STEP1, delta=100,
            protocol=jcore.AntiEntropyProtocol.PUSH, sampling_eval=0.1,
            sync=False)
    jst0 = jsim.init_nodes(key)
    jst, jrep = jsim.start(jst0, n_rounds=ROUNDS, key=key,
                           donate_state=False)
    runs = []
    for bf16 in (False, True):
        tsim = onoszko.onoszko_sim(stacked, STEP1,
                                   draws=JaxDraws(key, init_key=key),
                                   device="cpu", bf16=bf16)
        tst, trep = tsim.start(to_port_state(tsim, jst0), n_rounds=ROUNDS)
        runs.append((tsim, tst, trep))
    (tsim, tst, trep), (bsim, bst, _) = runs
    assert tsim.n_sampled == 2 and tsim.fused_merge is False
    assert_same_accounting(jsim, tsim, jst, tst, jrep, trep)
    for k in ("selected", "neigh_counter", "cache_sender", "cache_count",
              "best"):
        np.testing.assert_array_equal(tst.aux[k].numpy(),
                                      np.asarray(jst.aux[k]), err_msg=k)
    assert tst.aux["best"].any() and trep.sent_messages > 0
    got = flat(params_to_numpy(tst.model.params, tsim.handler.layout))
    ref = flat(flatten_names(jst.model.params))
    effect = np.abs(flat(params_to_numpy(bst.model.params,
                                         bsim.handler.layout)) - got)
    diff = np.abs(got - ref)
    assert np.isfinite(got).all()
    assert np.median(diff) <= 1e-6, np.median(diff)
    assert diff.max() <= 0.5 * effect.max(), (diff.max(), effect.max())
