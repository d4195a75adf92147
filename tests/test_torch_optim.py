"""The port's optimizers against optax, and optax state carried across.

Each rule runs on per-node rows ``[N, F]``: the port's update takes the
whole stack at once (one step count per node for adam), optax runs under
``jax.vmap`` over the node axis. Five steps of random gradients; params
and every state tensor within 1e-6 (elementwise, the same operations in
the same order). Columns that are zero in the params and the gradients
(the flat layout's padding) stay exactly zero under every rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gossipy_tpu_torch import optim
from gossipy_tpu_torch.convert import opt_state_from_jax
from gossipy_tpu_torch.models import ParamLayout

N, F, PAD = 3, 12, 2
TOL = dict(rtol=1e-6, atol=1e-6)

RULES = {
    "sgd": (lambda: optax.sgd(0.05), lambda: optim.sgd(0.05)),
    "sgd-momentum": (lambda: optax.sgd(0.05, momentum=0.9),
                     lambda: optim.sgd(0.05, momentum=0.9)),
    "sgd-nesterov": (lambda: optax.sgd(0.05, momentum=0.9, nesterov=True),
                     lambda: optim.sgd(0.05, momentum=0.9, nesterov=True)),
    "decay-sgd": (lambda: optax.chain(optax.add_decayed_weights(1e-3),
                                      optax.sgd(0.05)),
                  lambda: optim.chain(optim.add_decayed_weights(1e-3),
                                      optim.sgd(0.05))),
    "decay-momentum": (lambda: optax.chain(optax.add_decayed_weights(0.1),
                                           optax.sgd(0.05, momentum=0.5)),
                       lambda: optim.chain(optim.add_decayed_weights(0.1),
                                           optim.sgd(0.05, momentum=0.5))),
    "adam": (lambda: optax.adam(0.02), lambda: optim.adam(0.02)),
    "decay-adam": (lambda: optax.chain(optax.add_decayed_weights(1e-2),
                                       optax.adam(0.02, eps_root=1e-9)),
                   lambda: optim.chain(optim.add_decayed_weights(1e-2),
                                       optim.adam(0.02, eps_root=1e-9))),
}
STATE_LEN = {"sgd": 0, "sgd-momentum": 1, "sgd-nesterov": 1, "decay-sgd": 0,
             "decay-momentum": 1, "adam": 3, "decay-adam": 3}


def layout():
    """One leaf ``w`` of F scalars (a multiple of 4: rows of F); its last
    PAD columns stand for the layout's padding."""
    return ParamLayout([("w", (F,))])


def rows(rng, zero_pad=True):
    a = rng.normal(size=(N, F)).astype(np.float32)
    if zero_pad:
        a[:, F - PAD:] = 0.0
    return a


@pytest.mark.parametrize("name", list(RULES))
def test_rule_matches_optax_on_node_rows(name):
    jrule, trule = (f() for f in RULES[name])
    rng = np.random.default_rng(3)
    p0 = rows(rng)
    pj, pt = {"w": jnp.asarray(p0)}, torch.from_numpy(p0.copy())
    sj, st = jax.vmap(jrule.init)(pj), trule.init(pt)
    assert len(st) == trule.n_state == STATE_LEN[name]
    for step in range(5):
        g = rows(rng)
        uj, sj = jax.vmap(jrule.update)({"w": jnp.asarray(g)}, sj, pj)
        pj = optax.apply_updates(pj, uj)
        ut, st = trule.update(torch.from_numpy(g), st, pt)
        pt = optim.apply_updates(pt, ut)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj["w"]), **TOL,
                                   err_msg=f"step {step}")
        want = opt_state_from_jax(jax.tree.map(np.asarray, sj), layout(),
                                  trule)
        for a, b in zip(st, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    # The padding columns stay exactly zero, in the params and the state.
    assert (pt[:, F - PAD:] == 0).all()
    for t in st:
        if t.dim() == 2:
            assert (t[:, F - PAD:] == 0).all()


def test_adam_counts_per_node():
    """adam keeps one int32 step count per row ([N]) and bias-corrects
    each row with its own count."""
    rule = optim.adam(0.1)
    p = torch.ones(N, F)
    count, mu, nu = rule.init(p)
    assert count.shape == (N,) and count.dtype == torch.int32
    state = (torch.tensor([0, 3, 7], dtype=torch.int32), mu, nu)
    g = torch.full((N, F), 0.5)
    u, (count, _, _) = rule.update(g, state, p)
    assert count.tolist() == [1, 4, 8]
    # From zero moments, step t gives -lr * (1 - b1) g / (1 - b1^t) / ...:
    # a row's update depends on its own count.
    assert len({float(u[i, 0]) for i in range(N)}) == N
    one = optim.adam(0.1).init({"w": torch.ones(2)})
    assert one.count.shape == ()


def test_decay_needs_params():
    rule = optim.add_decayed_weights(0.1)
    with pytest.raises(ValueError, match="params"):
        rule.update(torch.ones(2, 3), (), None)


def test_opt_state_from_jax_rejects_mismatch():
    lay = layout()
    sj = jax.vmap(optax.adam(0.1).init)({"w": jnp.ones((N, F))})
    with pytest.raises(ValueError, match="keeps 0"):
        opt_state_from_jax(jax.tree.map(np.asarray, sj), lay,
                           optim.sgd(0.1))
    sj = jax.vmap(optax.scale_by_schedule(lambda c: 1.0).init)(
        {"w": jnp.ones((N, F))})
    with pytest.raises(ValueError, match="no counterpart"):
        opt_state_from_jax(jax.tree.map(np.asarray, sj), lay,
                           optim.sgd(0.1))
