"""Functional optimizers: optax's gradient transformations in PyTorch.

Counterpart of the ``optax`` transformations the JAX package uses. An
optimizer is an ``(init, update)`` pair as in optax: ``init(params)`` gives
the state, ``update(grads, state, params)`` gives ``(updates,
new_state)``, and :func:`apply_updates` adds the updates to the params.
Nothing is modified in place.

``params`` is either a stack of flat rows ``[N, F]`` (a population, as the
handlers keep it: each row is one node and the state keeps one step count
per node, ``[N]``) or a dict of tensors (one model; a 0-d count). The
state is a flat tuple of tensors: ``()`` for a stateless rule, and a
:func:`chain`'s state is its rules' states one after the other. The
update order and rounding are optax's: ``g + wd p`` (decay), ``g + m t``
(momentum), ``-lr u`` (the step), then ``p + u``. Zero columns of a row
(the layout's padding) have zero gradients and stay exactly zero.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Union

import torch

Params = Union[torch.Tensor, Dict[str, torch.Tensor]]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable
    n_state: int = 0   # tensors in the state tuple


class AdamState(NamedTuple):
    count: torch.Tensor   # int32, [N] for rows, 0-d for a dict
    mu: Params
    nu: Params


def _map(fn, *trees):
    """``fn`` leaf by leaf over dicts of tensors, or on tensors."""
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _per_row(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``v`` (one value per row, ``[N]``, or 0-d) broadcast against
    ``like`` (``[N, F]``, or any shape for a 0-d ``v``)."""
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


def _zeros(params: Params) -> Params:
    return _map(torch.zeros_like, params)


def _count_shape(params: Params) -> tuple:
    return tuple(params.shape[:-1]) if isinstance(params, torch.Tensor) \
        else ()


def sgd(learning_rate: float, momentum: Optional[float] = None,
        nesterov: bool = False) -> Optimizer:
    """``optax.sgd``: ``chain(trace(momentum, nesterov), -lr)``; state
    ``(trace,)`` with momentum, else ``()``.

        t = g + m t;   u = g + m t (nesterov) or t;   update = -lr u
    """
    lr = float(learning_rate)

    def init(params):
        return () if momentum is None else (_zeros(params),)

    def update(grads, state, params=None):
        del params
        if momentum is None:
            return _map(lambda g: -lr * g, grads), ()
        (trace,) = state
        new = _map(lambda g, t: g + momentum * t, grads, trace)
        u = _map(lambda g, t: g + momentum * t, grads, new) if nesterov \
            else new
        return _map(lambda g: -lr * g, u), (new,)

    return Optimizer(init, update, 0 if momentum is None else 1)


def add_decayed_weights(weight_decay: float) -> Optimizer:
    """``optax.add_decayed_weights``: ``g + wd * p``; no state."""
    wd = float(weight_decay)

    def init(params):
        return ()

    def update(grads, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the params")
        return _map(lambda g, p: g + wd * p, grads, params), ()

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         eps_root: float = 0.0) -> Optimizer:
    """``optax.adam``: bias-corrected first and second moments, ``eps``
    outside the square root, ``eps_root`` inside it, then ``-lr`` times
    the result; state :class:`AdamState` ``(count, mu, nu)``:

        mu = (1 - b1) g + b1 mu;   nu = (1 - b2) g^2 + b2 nu;   t += 1
        update = -lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t) + eps_root) + eps)
    """

    def init(params):
        first = next(iter(params.values())) if isinstance(params, dict) \
            else params
        count = torch.zeros(_count_shape(params), dtype=torch.int32,
                            device=first.device)
        return AdamState(count, _zeros(params), _zeros(params))

    def update(grads, state, params=None):
        del params
        count, mu, nu = state
        count = count + 1
        mu = _map(lambda g, m: (1 - b1) * g + b1 * m, grads, mu)
        nu = _map(lambda g, v: (1 - b2) * g ** 2 + b2 * v, grads, nu)
        t = count.to(torch.float32)
        bc1 = 1 - torch.pow(b1, t)
        bc2 = 1 - torch.pow(b2, t)
        updates = _map(lambda m, v: -lr * ((m / _per_row(bc1, m))
                                           / (torch.sqrt(v / _per_row(bc2, v)
                                                         + eps_root) + eps)),
                       mu, nu)
        return updates, AdamState(count, mu, nu)

    return Optimizer(init, update, 3)


def chain(*rules: Optimizer) -> Optimizer:
    """``optax.chain``: the rules in turn, each on the previous one's
    updates; the state is the rules' states concatenated."""

    def init(params):
        return tuple(s for rule in rules for s in rule.init(params))

    def update(grads, state, params=None):
        out, pos = [], 0
        for rule in rules:
            mine = tuple(state[pos:pos + rule.n_state])
            grads, new = rule.update(grads, mine, params)
            out.extend(new)
            pos += rule.n_state
        return grads, tuple(out)

    return Optimizer(init, update, sum(rule.n_state for rule in rules))


def apply_updates(params: Params, updates: Params) -> Params:
    """``optax.apply_updates``: ``params + updates``, leaf by leaf, in each
    param's type."""
    return _map(lambda p, u: (p + u).to(p.dtype), params, updates)
