"""Token-account flow control (Danner 2018) over the node axis.

Counterpart of ``gossipy_tpu/flow_control.py``: an account type is a
static policy whose ``proactive`` and ``reactive`` rules map the whole
``[N]`` int32 balance tensor to send probabilities and reaction counts.
The balances live in the tokenized simulator's ``state.aux``. The
randomised rounding of :class:`RandomizedTokenAccount` takes a uniform
``[N]`` draw ``u`` from the simulation's draw provider in place of a JAX
key (``bernoulli(key, p)`` is ``uniform(key) < p``); the other accounts
draw nothing (``draws_reactive = False``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class TokenAccount:
    """Base policy: ``proactive(balance)`` gives each node's probability of
    sending at its timeout, ``reactive(balance, utility, u)`` the number
    of reaction sends a received message of that utility triggers."""

    draws_reactive = False

    def init_balance(self, n_nodes: int, device=None) -> torch.Tensor:
        return torch.zeros(n_nodes, dtype=torch.int32, device=device)

    def proactive(self, balance: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def reactive(self, balance: torch.Tensor, utility: torch.Tensor,
                 u: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class PurelyProactiveTokenAccount(TokenAccount):
    """Always send, never react: vanilla push gossip."""

    def proactive(self, balance):
        return torch.ones_like(balance, dtype=torch.float32)

    def reactive(self, balance, utility, u=None):
        return torch.zeros_like(balance)


@dataclasses.dataclass(frozen=True)
class PurelyReactiveTokenAccount(TokenAccount):
    """Never proactive; react with ``utility * k`` sends."""

    k: int = 1

    def proactive(self, balance):
        return torch.zeros_like(balance, dtype=torch.float32)

    def reactive(self, balance, utility, u=None):
        return (utility * self.k).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class SimpleTokenAccount(TokenAccount):
    """Proactive iff the balance reaches the capacity ``C``; one reaction
    iff the balance is positive."""

    C: int = 1

    def __post_init__(self):
        if self.C < 1:
            raise ValueError("The capacity C must be strictly positive.")

    def proactive(self, balance):
        return (balance >= self.C).to(torch.float32)

    def reactive(self, balance, utility, u=None):
        return (balance > 0).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class GeneralizedTokenAccount(SimpleTokenAccount):
    """Danner 2018's generalised reactive rule: ``(A - 1 + a) // A``
    reactions for a useful message, ``(A - 1 + a) // (2 A)`` otherwise."""

    A: int = 1

    def __post_init__(self):
        if self.C < 1:
            raise ValueError("The capacity C must be positive.")
        if self.A < 1:
            raise ValueError("The reactivity A must be positive.")
        if self.A > self.C:
            raise ValueError("The capacity C must be greater or equal than "
                             "the reactivity A.")

    def reactive(self, balance, utility, u=None):
        num = self.A - 1 + balance
        out = torch.where(utility > 0, torch.div(num, self.A,
                                                 rounding_mode="floor"),
                          torch.div(num, 2 * self.A, rounding_mode="floor"))
        return out.to(torch.int32)


@dataclasses.dataclass(frozen=True)
class RandomizedTokenAccount(GeneralizedTokenAccount):
    """A linear proactive ramp on ``[A - 1, C]``; reactions ``a / A``
    rounded at random (up with the probability of the fraction, from the
    uniform draw ``u``)."""

    draws_reactive = True

    def proactive(self, balance):
        b = balance.to(torch.float32)
        ramp = (b - self.A + 1) / float(self.C - self.A + 1)
        return torch.clamp(torch.where(b < self.A - 1,
                                       torch.zeros_like(ramp), ramp),
                           0.0, 1.0)

    def reactive(self, balance, utility, u=None):
        r = balance.to(torch.float32) / self.A
        frac = r - torch.floor(r)
        up = (u < torch.clamp(frac, 0.0, 1.0)).to(torch.int32)
        rounded = torch.floor(r).to(torch.int32) + up
        return torch.where(utility > 0, rounded, torch.zeros_like(rounded))
