"""The north-star configuration end to end, held against the JAX engine.

``bench.py::build_sim``: 100 nodes on ``random_regular(100, 20, seed=42)``,
``LogisticRegression(57, 2)`` under SGD 0.1 (batch 32, one local epoch),
MERGE_UPDATE and PUSH, the offline spambase stand-in split 80/20 with the
20% as the global eval set, a global eval every round. Each package builds
its side with its own topology, loader, data handler and dispatcher; the
JAX side's features come from its synthetic generator and scikit-learn's
``StandardScaler`` (its loader would try a download first). 10 rounds
under the JAX draw oracle on the default path (``fused_merge=False``,
compaction on by itself at N = 100) and on ``"multi"``; then the paper
examples' network model (``UniformDelay(0, 10)``, 10% drops, 20% online,
``sampling_eval=0.1``) with PUSH_PULL on ``"multi"``. Integer accounting,
mailbox and reply box exactly; params within 1e-5; the mean accuracy of
the eval within 1e-5.
"""

import warnings

import jax
import numpy as np
import pytest
import torch
from sklearn.preprocessing import StandardScaler

from gossipy_tpu import core as jcore
from gossipy_tpu import data as jdata
from gossipy_tpu_torch import core as tcore
from gossipy_tpu_torch import data as tdata
from torch_pairs import make_pair, run_both

torch.set_num_threads(1)

N_NODES, DEGREE, ROUNDS = 100, 20, 10


def stacked_pair():
    """Each package's ``disp.stacked()`` of the spambase stand-in."""
    n, d, c = jdata.UCI_SHAPES["spambase"]
    Xj, yj = jdata._synthetic_classification("spambase", n, d, c)
    Xj = StandardScaler().fit_transform(Xj).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        Xt, yt = tdata.load_classification_dataset("spambase")
    out = []
    for pkg, X, y in ((jdata, Xj, yj), (tdata, Xt, yt)):
        dh = pkg.ClassificationDataHandler(X, y, test_size=0.2, seed=42)
        out.append(pkg.DataDispatcher(dh, n=N_NODES,
                                      eval_on_user=False).stacked())
    return out


def northstar_pair(key, **kw):
    jd, td = stacked_pair()
    assert sorted(jd) == sorted(td) == ["mtr", "x_eval", "xtr", "y_eval",
                                        "ytr"]
    for k in jd:
        np.testing.assert_allclose(td[k], jd[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    jtopo = jcore.Topology.random_regular(N_NODES, DEGREE, seed=42,
                                          backend="networkx")
    ttopo = tcore.Topology.random_regular(N_NODES, DEGREE, seed=42,
                                          backend="networkx")
    return make_pair(jtopo, ttopo, jd, td, key, d_feat=57, batch=32, **kw)


@pytest.mark.parametrize("fused", [False, "multi"])
def test_northstar_rounds_match_jax_engine(fused):
    key = jax.random.PRNGKey(42)
    jsim, tsim = northstar_pair(key, fused_merge=fused)
    assert tsim._compact_cap == jsim._compact_cap
    assert (tsim._compact_cap is not None) == (fused is False)
    trep = run_both(jsim, tsim, key, rounds=ROUNDS, common_init=False)
    assert (trep.sent_per_round == N_NODES).all()
    assert np.isfinite(trep.curves(False)["accuracy"]).all()


def test_examples_network_model_matches_jax_engine():
    key = jax.random.PRNGKey(7)
    jsim, tsim = northstar_pair(
        key, fused_merge="multi", delay=tcore.UniformDelay(0, 10),
        drop_prob=0.1, online_prob=0.2, sampling_eval=0.1,
        protocol=tcore.AntiEntropyProtocol.PUSH_PULL)
    trep = run_both(jsim, tsim, key, rounds=ROUNDS, common_init=False)
    assert trep.failed_per_cause["offline"].sum() > 0
