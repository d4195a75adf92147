"""PULL and PUSH_PULL replies and sampled evaluation, held against the JAX
engine on each deliver path under the JAX draw oracle (``torch_pairs``:
integer accounting, mailbox and reply box exactly; params and metrics
within 1e-5). Delays and async nodes: ``test_torch_delays.py``; the
north-star configuration: ``test_torch_northstar.py``.
"""

import jax
import pytest
import torch

from gossipy_tpu_torch import core as tcore
from torch_pairs import N, PATHS, clique_pair, run_both

torch.set_num_threads(1)

PULL = tcore.AntiEntropyProtocol.PULL
PUSH_PULL = tcore.AntiEntropyProtocol.PUSH_PULL


@pytest.mark.parametrize("protocol,path", [
    (PULL, "plain-compact"), (PULL, "per_slot"), (PULL, "multi"),
    (PUSH_PULL, "plain"), (PUSH_PULL, "per_slot"),
    (PUSH_PULL, "multi-compact")])
def test_replies_match_jax_engine(protocol, path):
    """Requests, the replies they ask for (the reply box with its drops,
    delays and overflow at Kr = 1) and the reply phase, which drains the
    reply box through the deliver path (K1 on multi, K3 on per_slot)."""
    fused, compact = PATHS[path]
    key = jax.random.PRNGKey(8)
    jsim, tsim = clique_pair(key, protocol=protocol, fused_merge=fused,
                             compact_deliver=compact, mailbox_slots=4,
                             reply_slots=1, drop_prob=0.1, online_prob=0.8,
                             delay=tcore.UniformDelay(0, 120))
    trep = run_both(jsim, tsim, key)
    causes = {c: int(v.sum()) for c, v in trep.failed_per_cause.items()}
    assert min(causes.values()) > 0, causes
    assert (trep.compact_slots_per_round + trep.wide_slots_per_round).sum()


def test_pull_requests_have_size_one():
    """A PULL request counts one scalar, its reply the model's size."""
    key = jax.random.PRNGKey(2)
    jsim, tsim = clique_pair(key, protocol=PULL, mailbox_slots=4,
                             reply_slots=4)
    rounds = 2
    trep = run_both(jsim, tsim, key, rounds=rounds)
    requests = N * rounds  # every node of the clique sends one per round
    replies = int(trep.sent_per_round.sum()) - requests
    assert replies > 0
    assert trep.total_size == requests + replies * tsim.handler.get_size()


@pytest.mark.parametrize("path", ["plain", "multi"])
def test_sampling_eval_matches_jax_engine(path):
    """The sampled node subset (``K_EVAL``) for local and global metrics."""
    fused, compact = PATHS[path]
    key = jax.random.PRNGKey(13)
    jsim, tsim = clique_pair(key, sampling_eval=0.3, fused_merge=fused,
                             compact_deliver=compact, mailbox_slots=4,
                             drop_prob=0.1)
    assert tsim._n_eval_nodes() == jsim._n_eval_nodes() == 3
    run_both(jsim, tsim, key)
