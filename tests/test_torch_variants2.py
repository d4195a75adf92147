"""The flow-control and all-to-all simulators
(``gossipy_tpu/simulation/variants.py``) against the JAX package's, from
the same state under the JAX draw oracle (``torch_pairs.check_variant``,
as in ``test_torch_variants.py``).

- ``TokenizedGossipSimulator`` under a simple and a randomised token
  account (2 reactions a round at most, delays past a round so that
  messages and reactions cross rounds): one JAX run on the plain path;
  the port's plain and per-slot fused paths held against it.
- ``TokenizedPartitioningGossipSimulator`` runs in
  ``test_torch_papers2.py`` (Hegedus 2021), its partition payloads on
  the compacted pass in ``test_torch_variants.py``.
- ``All2AllGossipSimulator`` under uniform and Metropolis-Hastings
  weights on a Barabasi-Albert graph (where the two differ), with drops
  and offline receivers, on an fp32 and a bf16 wire.
Accounting, boxes, ages, ``aux`` exactly; params within 1e-5 (a bf16
wire adds one encoding step).
"""

import numpy as np
import pytest
import torch

from gossipy_tpu_torch import core as tcore
from gossipy_tpu_torch import flow_control as tflow
from gossipy_tpu_torch import simulation as tsimulation
from torch_pairs import check_variant, logreg, make, small_data, topology

torch.set_num_threads(1)

ACCOUNTS = {"simple": tflow.SimpleTokenAccount(C=1),
            "randomized": tflow.RandomizedTokenAccount(C=3, A=1)}
PATHS = {"plain": dict(fused_merge=False),
         "per_slot": dict(fused_merge="per_slot")}


def tokenized(account):
    def build(key, **kw):
        kw = {"fused_merge": False, **kw}
        return make("TokenizedGossipSimulator", logreg(),
                    topology("regular"), small_data(), key,
                    token_account=ACCOUNTS[account], max_reactions=2,
                    delay=tcore.UniformDelay(0, 150), sync=True, **kw)
    return build


TOKENIZED = {a: tokenized(a) for a in ACCOUNTS}


def all2all(mixing, wire):
    def build(key, **kw):
        return make("All2AllGossipSimulator", logreg("weighted"),
                    topology("ba"), small_data(), key, mixing=mixing,
                    sync=False, drop_prob=0.1, online_prob=0.8,
                    history_dtype=wire, **kw)
    return build


ALL2ALL = {(m, w): all2all(m, w)
           for m in ("uniform_mixing", "metropolis_hastings_mixing")
           for w in ("float32", "bfloat16")}


@pytest.mark.parametrize("path", ["plain", "per_slot"])
@pytest.mark.parametrize("account", sorted(ACCOUNTS))
def test_tokenized_matches_jax(account, path):
    tsim, tst, trep = check_variant(TOKENIZED[account], 25, 8,
                                    **PATHS[path])
    assert tsim.fused_merge == PATHS[path]["fused_merge"]
    # Some node banked a token (it was gated) or kept one back.
    assert (tst.aux["balance"] != 0).any()


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixing", ["uniform_mixing",
                                   "metropolis_hastings_mixing"])
def test_all2all_matches_jax(mixing, wire):
    tsim, _, trep = check_variant(ALL2ALL[(mixing, wire)], 27, 5)
    assert tsim.K == 1 and tsim.fused_merge is False
    causes = trep.failed_per_cause
    assert causes["drop"].sum() > 0 and causes["offline"].sum() > 0


def test_all2all_refuses_what_is_not_ported():
    topo = topology("ba")
    mix = tcore.uniform_mixing(topo)
    handler = logreg("weighted")[1]
    from gossipy_tpu_torch import parallel
    across = parallel.make_mesh(devices=[
        parallel.Position(torch.device("cpu"), rank, rank)
        for rank in (0, 1)])
    for kw, err in ((dict(ring_mix=True), ValueError),
                    (dict(mesh=across), NotImplementedError),
                    (dict(mesh=across, ring_mix=True), NotImplementedError)):
        with pytest.raises(err):
            tsimulation.All2AllGossipSimulator(handler, topo, small_data(),
                                               mixing=mix, device="cpu",
                                               **kw)
    with pytest.raises(ValueError):
        tsimulation.All2AllGossipSimulator(
            handler, topo, small_data(), mixing=mix, device="cpu",
            protocol=tcore.AntiEntropyProtocol.PUSH_PULL)
    with pytest.raises(ValueError):
        tsimulation.All2AllGossipSimulator(
            handler, topo, small_data(), mixing=np.eye(3), device="cpu")
