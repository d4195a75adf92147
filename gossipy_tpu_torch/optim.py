"""Functional optimizers over a dict of tensors.

Counterpart of the ``optax`` transformations the JAX package uses. An
optimizer is an ``(init, update)`` pair as in optax: ``init(params)`` gives
the state, ``update(grads, state)`` gives ``(updates, new_state)``, and
:func:`apply_updates` adds the updates to the params. Nothing is modified
in place.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

Params = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


class AdamState(NamedTuple):
    count: int
    mu: Params
    nu: Params


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         eps_root: float = 0.0) -> Optimizer:
    """``optax.adam``: bias-corrected first and second moments, ``eps``
    outside the square root, ``eps_root`` inside it, then ``-lr`` times
    the result:

        mu = (1 - b1) g + b1 mu;   nu = (1 - b2) g^2 + b2 nu;   t += 1
        update = -lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t) + eps_root) + eps)
    """

    def init(params: Params) -> AdamState:
        zeros = {k: torch.zeros_like(p) for k, p in params.items()}
        return AdamState(0, zeros, {k: z.clone() for k, z in zeros.items()})

    def update(grads: Params, state: AdamState, params=None):
        del params
        count = state.count + 1
        mu = {k: (1 - b1) * g + b1 * state.mu[k] for k, g in grads.items()}
        nu = {k: (1 - b2) * g ** 2 + b2 * state.nu[k]
              for k, g in grads.items()}
        bc1 = 1 - b1 ** count
        bc2 = 1 - b2 ** count
        updates = {k: -lr * ((mu[k] / bc1)
                             / (torch.sqrt(nu[k] / bc2 + eps_root) + eps))
                   for k in grads}
        return updates, AdamState(count, mu, nu)

    return Optimizer(init, update)


def apply_updates(params: Params, updates: Params) -> Params:
    """``optax.apply_updates``: ``params + updates``, leaf by leaf, in each
    param's type."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}
