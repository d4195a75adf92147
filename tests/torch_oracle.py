"""The JAX draw oracle: a port draw provider that replays the JAX engine's
keys, so a port run and a JAX run consume the same random numbers.

The JAX engine derives every draw of round ``r`` and purpose ``p`` from
``fold_in(fold_in(base, r), p)`` (``GossipSimulator._round_key``), and
``init_nodes(key)`` splits ``key`` into ``(k_init, k_phase, k_up)``. The
oracle recomputes those keys with ``jax.random`` and hands the values to
the port as tensors. Test-only: the port itself never imports JAX.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gossipy_tpu.core import sample_peers
from gossipy_tpu_torch.random import K_PEER, DrawProvider


def perms_from_keys(keys, epochs: int, s: int) -> np.ndarray:
    """What ``SGDHandler.update`` draws from each node key: ``[n, epochs,
    s]`` permutations, one per ``split(key, epochs)`` entry."""
    def one(key):
        return jax.vmap(lambda k: jax.random.permutation(k, s))(
            jax.random.split(key, epochs))
    return np.array(jax.vmap(one)(keys))


class JaxDraws(DrawProvider):
    """Replays the JAX engine's draws from ``round_key`` (the key passed to
    ``start``) and ``init_key`` (the key passed to ``init_nodes``)."""

    def __init__(self, round_key, init_key=None):
        self.base = round_key
        if init_key is not None:
            _, self.k_phase, self.k_up = jax.random.split(init_key, 3)

    def _key(self, r, purpose):
        return jax.random.fold_in(jax.random.fold_in(self.base, r), purpose)

    def init_phase(self, n, delta, device):
        ph = jax.random.randint(self.k_phase, (n,), 0, delta,
                                dtype=jnp.int32)
        return torch.as_tensor(np.array(ph), device=device)

    def init_permutations(self, n, epochs, s, device):
        keys = jax.random.split(self.k_up, n)
        return torch.as_tensor(perms_from_keys(keys, epochs, s),
                               device=device).long()

    def peers(self, r, adjacency):
        adj = jnp.asarray(adjacency.cpu().numpy())
        p = sample_peers(self._key(r, K_PEER), adj)
        return torch.as_tensor(np.array(p), device=adjacency.device).long()

    def bernoulli(self, r, purpose, p, n, device):
        b = jax.random.bernoulli(self._key(r, purpose), p, (n,))
        return torch.as_tensor(np.array(b), device=device)

    def update_permutations(self, r, purposes, first_k, epochs, s):
        n = first_k.shape[0]
        tabs = jnp.stack([jax.random.split(self._key(r, p), n)
                          for p in purposes])
        keys = tabs[jnp.asarray(first_k.cpu().numpy()), jnp.arange(n)]
        return torch.as_tensor(perms_from_keys(keys, epochs, s),
                               device=first_k.device).long()
