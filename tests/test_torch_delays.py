"""Message delays and async nodes, held against the JAX engine on each
deliver path under the JAX draw oracle (``torch_pairs``: integer
accounting, mailbox and reply box exactly; params and metrics within
1e-5). Delayed runs are held to the JAX engine's own values, not to an
accuracy threshold.
"""

import jax
import numpy as np
import pytest
import torch

from gossipy_tpu import core as jcore
from gossipy_tpu_torch import core as tcore
from torch_pairs import N, PATHS, clique_pair, make_pair, run_both, \
    small_data

torch.set_num_threads(1)


@pytest.mark.parametrize("delay,path", [
    *[(tcore.UniformDelay(0, 10), p) for p in PATHS],
    (tcore.UniformDelay(40, 260), "plain-compact"),
    (tcore.UniformDelay(40, 260), "multi")])
def test_delays_match_jax_engine(delay, path):
    """Delayed messages land in later mailbox cells and are read from
    older ring cells; drops and offline receivers on top."""
    fused, compact = PATHS[path]
    key = jax.random.PRNGKey(21)
    jsim, tsim = clique_pair(key, delay=delay, fused_merge=fused,
                             compact_deliver=compact, mailbox_slots=4,
                             drop_prob=0.1, online_prob=0.8)
    trep = run_both(jsim, tsim, key)
    assert trep.failed_per_cause["drop"].sum() > 0


@pytest.mark.parametrize("path,wire", [("per_slot", "bfloat16"),
                                       ("multi", "int8"),
                                       ("plain-compact", "int8")])
def test_delays_on_quantized_rings_match_jax_engine(path, wire):
    """Delayed payloads read from older cells of a bf16 or int8 ring (and
    its int8 scales) on each path."""
    fused, compact = PATHS[path]
    key = jax.random.PRNGKey(5)
    jsim, tsim = clique_pair(key, delay=tcore.UniformDelay(40, 260),
                             fused_merge=fused, compact_deliver=compact,
                             mailbox_slots=4, history_dtype=wire,
                             drop_prob=0.1, online_prob=0.8)
    run_both(jsim, tsim, key)


@pytest.mark.parametrize("path", ["plain", "per_slot", "multi"])
def test_async_subfires_match_jax_engine(path):
    """Async periods (``init_nodes``' normal draw) and F = 2 sub-fires,
    each under its own keys."""
    fused, compact = PATHS[path]
    key = jax.random.PRNGKey(4)
    jsim, tsim = clique_pair(key, sync=False, max_fires_per_round=2,
                             fused_merge=fused, compact_deliver=compact,
                             mailbox_slots=6,
                             delay=tcore.LinearDelay(0.5, 3))
    assert tsim.F == jsim.F == 2
    jst = jsim.init_nodes(key, common_init=True)
    tst = tsim.init_nodes(local_train=False)
    np.testing.assert_array_equal(tst.phase.numpy(), np.asarray(jst.phase))
    trep = run_both(jsim, tsim, key)
    # Every async node fires at time 0; one with a period under delta
    # fires twice in round 0.
    assert trep.sent_per_round[0] > N


def test_async_derives_the_reference_mailbox():
    """``_lam_vector`` counts the sub-fires: the automatic K of an async
    simulator is the JAX engine's."""
    key = jax.random.PRNGKey(0)
    hub = np.zeros((N, N), dtype=bool)
    hub[1:, 0] = hub[0, 1:] = True
    data = small_data()
    for kw in ({"sync": False}, {"sync": False, "max_fires_per_round": 3},
               {}):
        jsim, tsim = make_pair(jcore.Topology(hub), tcore.Topology(hub),
                               data, data, key, **kw)
        assert tsim.F == jsim.F and tsim.K == jsim.K
