"""The JAX draw oracle: a port draw provider that replays the JAX engine's
keys, so a port run and a JAX run consume the same random numbers.

The JAX engine derives every draw of round ``r`` and purpose ``p`` from
``fold_in(fold_in(base, r), p)`` (``GossipSimulator._round_key``), and
``init_nodes(key)`` splits ``key`` into ``(k_init, k_phase, k_up)``. The
oracle recomputes those keys with ``jax.random`` and hands the values to
the port as tensors. Sub-fire ``f > 0`` of an async round folds ``f`` into
each purpose key and draws its peers from ``fold_in(_round_key(r, K_FIRE),
f)`` as the base (engine.py ``_send_phase``), as do the other send-hook
draws (``uniform``, ``choice``, ``cohort_peers``). The variants' draws
replay their JAX expressions: the token gate and the reactive rounding as
``uniform(key) < p``, the neighbour cache's pop and PENS's pick as
``categorical`` over ``0 / -inf`` logits, the pass-through accept as
``bernoulli(fold_in(split(call key, n)[i], 911), p)``, and the sampled
merge's mask as ``sample_mask(fold_in(PRNGKey(0x5A11), payload), ...)``
(``gossipy_tpu/simulation/nodes.py``). The sequential engine's draws
replay ``gossipy_tpu/simulation/sequential.py``: host seeds from
``split(key)[0]`` (its ``fold_in(., 7)`` for the variants), every event
draw from ``fold_in(split(key)[1], e)``, the pre-training keys
``fold_in(k_up, i)`` and the phase seed from ``k_phase``. Test-only: the
port itself never imports JAX.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gossipy_tpu.compression import sample_mask
from gossipy_tpu.core import sample_peers
from gossipy_tpu_torch.random import K_EVAL, K_FIRE, K_PEER, DrawProvider


def perms_from_keys(keys, epochs: int, s: int,
                    split: bool = False) -> np.ndarray:
    """What ``SGDHandler.update`` draws from each node key: ``[n, epochs,
    s]`` permutations, one per ``split(key, epochs)`` entry, or with
    ``epochs=0`` the one ``permutation(key, s)`` of a single step (``[n,
    1, s]``). ``split``: what the UPDATE_MERGE ``call`` draws, the orders
    of ``k1`` then ``k2`` of ``split(key)`` along the epoch axis."""
    return np.array(_perms(keys, epochs, s, split))


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _perms(keys, epochs, s, split):
    def one(key):
        if epochs == 0:
            return jax.random.permutation(key, s)[None]
        return jax.vmap(lambda k: jax.random.permutation(k, s))(
            jax.random.split(key, epochs))

    def two(key):
        k1, k2 = jax.random.split(key)
        return jnp.concatenate([one(k1), one(k2)])
    return jax.vmap(two if split else one)(keys)


class JaxDraws(DrawProvider):
    """Replays the JAX engine's draws from ``round_key`` (the key passed to
    ``start``) and ``init_key`` (the key passed to ``init_nodes``)."""

    SAMPLE_KEY = 0x5A11

    def __init__(self, round_key, init_key=None):
        self.base = round_key
        self.init_key = init_key
        if init_key is not None:
            _, self.k_phase, self.k_up = jax.random.split(init_key, 3)

    def _key(self, r, purpose, sub=0, base=None):
        base = self.base if base is None else base
        k = jax.random.fold_in(jax.random.fold_in(base, r), purpose)
        return jax.random.fold_in(k, sub) if sub > 0 else k

    def _hook_key(self, r, purpose, sub=0):
        """A send hook's key: sub-fire ``f > 0`` derives it from the
        sub-fire's base."""
        base = None if sub == 0 else self._key(r, K_FIRE, sub)
        return self._key(r, purpose, base=base)

    def derive(self, tag):
        out = JaxDraws(jax.random.fold_in(self.base, tag), self.init_key)
        return out

    def init_phase(self, n, delta, device):
        ph = jax.random.randint(self.k_phase, (n,), 0, delta,
                                dtype=jnp.int32)
        return torch.as_tensor(np.array(ph), device=device)

    def init_permutations(self, n, epochs, s, device):
        keys = jax.random.split(self.k_up, n)
        return torch.as_tensor(perms_from_keys(keys, epochs, s),
                               device=device).long()

    def init_period(self, n, delta, device):
        raw = delta + (delta / 10.0) * jax.random.normal(self.k_phase, (n,))
        ph = jnp.maximum(raw.astype(jnp.int32), 1)
        return torch.as_tensor(np.array(ph), device=device)

    def peers(self, r, adjacency, sub=0, purpose=K_PEER, fold=0):
        if getattr(self, "_adj", (None,))[0] is not adjacency:
            self._adj = (adjacency, jnp.asarray(adjacency.cpu().numpy()))
        key = self._hook_key(r, purpose, sub)
        if fold:
            key = jax.random.fold_in(key, fold)
        p = _sample_peers(key, self._adj[1])
        return torch.as_tensor(np.array(p), device=adjacency.device).long()

    def csr_peers(self, r, csr, sub=0, purpose=K_PEER, fold=0):
        """``SparseTopology.sample_peers``: ``randint`` into each CSR
        row."""
        if getattr(self, "_csr", (None,))[0] is not csr:
            self._csr = (csr, tuple(jnp.asarray(t.cpu().numpy(), jnp.int32)
                                    for t in csr))
        key = self._hook_key(r, purpose, sub)
        if fold:
            key = jax.random.fold_in(key, fold)
        p = _csr_peers(key, *self._csr[1])
        return torch.as_tensor(np.array(p),
                               device=csr.degrees.device).long()

    def slot_peers(self, r, nbr, alive, sub=0, purpose=K_PEER):
        """The JAX engine's sparse chaos draw (``_chaos_masked_peers``,
        slot form): a categorical over the alive slots of the padded
        neighbour table."""
        p = _slot_peers(self._hook_key(r, purpose, sub),
                        jnp.asarray(nbr.cpu().numpy(), jnp.int32),
                        jnp.asarray(alive.cpu().numpy()))
        return torch.as_tensor(np.array(p), device=nbr.device).long()

    def cohort_peers(self, r, c, device, sub=0, purpose=K_PEER):
        """``_CohortRoundTopology.sample_peers`` under the send hook's
        key (cohort.py:181-184)."""
        p = _cohort_peers(self._hook_key(r, purpose, sub), c)
        return torch.as_tensor(np.array(p), device=device).long()

    def cohort_seed_material(self):
        """``cohort._seed_material(key)`` of the run's key."""
        return [int(x) for x in np.asarray(self.base).ravel().astype(
            np.uint32)]

    def bernoulli(self, r, purpose, p, n, device, sub=0):
        shape = (n,) if isinstance(n, int) else tuple(n)
        b = jax.random.bernoulli(self._key(r, purpose, sub), p, shape)
        return torch.as_tensor(np.array(b), device=device)

    def uniform(self, r, purpose, n, device, sub=0):
        u = jax.random.uniform(self._hook_key(r, purpose, sub), (n,))
        return torch.as_tensor(np.array(u), device=device)

    def choice(self, r, purpose, valid, sub=0):
        logits = jnp.where(jnp.asarray(valid.cpu().numpy()), 0.0, -jnp.inf)
        pick = jax.random.categorical(self._hook_key(r, purpose, sub),
                                      logits, axis=-1)
        return torch.as_tensor(np.array(pick), device=valid.device).long()

    def row_uniform(self, r, purpose, n, fold, device):
        u = _row_uniform(self._key(r, purpose), n, fold)
        return torch.as_tensor(np.array(u), device=device)

    def sample_mask(self, payload, layout, sample_size):
        """One key a row, ``fold_in(PRNGKey(0x5A11), payload)``, split
        over the layout's leaves in order (nodes.py:112-134)."""
        shapes = tuple(shape for _, shape in layout.leaves)
        flat = _sample_masks(jnp.asarray(payload.cpu().numpy()), shapes,
                             float(sample_size))
        out = np.zeros((payload.shape[0], layout.stride), dtype=bool)
        out[:, :layout.width] = np.asarray(flat)
        return torch.as_tensor(out, device=payload.device)

    def randint(self, r, purpose, lo, hi, n, device, sub=0):
        v = jax.random.randint(self._key(r, purpose, sub), (n,), lo, hi + 1,
                               dtype=jnp.int32)
        return torch.as_tensor(np.array(v), device=device).long()

    def eval_subset(self, r, n, n_pick, device):
        idx = jax.random.permutation(self._key(r, K_EVAL), n)[:n_pick]
        return torch.as_tensor(np.array(idx), device=device).long()

    # -- the sequential engine (sequential.py:288-330, 384-393, 456-459) --

    def seq_init_seed(self):
        return int(jax.random.randint(self.k_phase, (), 0, 2 ** 31 - 1))

    def seq_init_permutations(self, n, epochs, s, device):
        keys = _fold_keys(self.k_up, n)
        return torch.as_tensor(perms_from_keys(keys, epochs, s),
                               device=device).long()

    def seq_host_seeds(self):
        k_host = jax.random.split(self.base)[0]
        return (int(jax.random.randint(k_host, (), 0, 2 ** 31 - 1)),
                int(jax.random.randint(jax.random.fold_in(k_host, 7), (), 0,
                                       2 ** 31 - 1)))

    def _event_key(self, e):
        if getattr(self, "_ev_base", (None,))[0] is not self.base:
            self._ev_base = (self.base, jax.random.split(self.base)[1])
        return jax.random.fold_in(self._ev_base[1], e)

    def event_orders(self, e, epochs, s, split=False):
        keys = self._event_key(e)[None]
        return torch.as_tensor(perms_from_keys(keys, epochs, s,
                                               split)).long()

    def event_randint(self, e, lo, hi):
        return int(_event_randint(self._event_key(e), lo, hi + 1)[0])

    def event_uniform(self, e):
        return float(_event_uniform(self._event_key(e))[0])

    def update_permutations(self, r, purposes, first_k, epochs, s,
                            split=False):
        n = first_k.shape[0]
        tabs = jnp.stack([jax.random.split(self._key(r, p), n)
                          for p in purposes])
        keys = tabs[jnp.asarray(first_k.cpu().numpy()), jnp.arange(n)]
        return torch.as_tensor(perms_from_keys(keys, epochs, s, split),
                               device=first_k.device).long()


@functools.partial(jax.jit, static_argnums=(1,))
def _cohort_peers(key, c):
    """``(i + 1 + randint(key, (c,), 0, c - 1)) % c``."""
    r = jax.random.randint(key, (c,), 0, c - 1, dtype=jnp.int32)
    return (jnp.arange(c, dtype=jnp.int32) + 1 + r) % c


@functools.partial(jax.jit, static_argnums=(1,))
def _fold_keys(key, n):
    """``fold_in(key, i)`` for ``i`` in ``range(n)``."""
    return jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(n))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _event_randint(key, lo, hi):
    """A delay sample: ``randint(key, (1,), lo, hi, int32)``."""
    return jax.random.randint(key, (1,), lo, hi, dtype=jnp.int32)


@jax.jit
def _event_uniform(key):
    """What ``bernoulli(key, p)`` of a ``[1]`` ``p`` compares with ``p``."""
    return jax.random.uniform(key, (1,))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _row_uniform(key, n, fold):
    """``uniform(fold_in(split(key, n)[i], fold), ())`` for every row."""
    return jax.vmap(lambda k: jax.random.uniform(
        jax.random.fold_in(k, fold), ()))(jax.random.split(key, n))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _sample_masks(payload, shapes, sample_size):
    """The JAX sampled merge's flat masks, one row a payload; a list of
    leaves keeps the layout's order through the tree flattening."""
    base = jax.random.PRNGKey(JaxDraws.SAMPLE_KEY)

    def one(e):
        masks = sample_mask(jax.random.fold_in(base, e),
                            [jnp.zeros(s) for s in shapes], sample_size)
        return jnp.concatenate([m.ravel() for m in masks])
    return jax.vmap(one)(payload)


_sample_peers = jax.jit(sample_peers)


@jax.jit
def _csr_peers(key, indptr, indices, degrees):
    """``gossipy_tpu.core.SparseTopology.sample_peers`` over the CSR
    arrays."""
    r = jax.random.randint(key, degrees.shape, 0, jnp.maximum(degrees, 1),
                           dtype=jnp.int32)
    peers = indices[indptr[:-1] + r]
    return jnp.where(degrees > 0, peers, -1).astype(jnp.int32)


@jax.jit
def _slot_peers(key, nbr, alive):
    """The slot form of ``GossipSimulator._chaos_masked_peers``."""
    logits = jnp.where(alive, 0.0, -jnp.inf)
    slot = jax.random.categorical(key, logits, axis=-1)
    has = alive.any(axis=-1)
    peers = nbr[jnp.arange(nbr.shape[0]), jnp.clip(slot, 0, nbr.shape[1] - 1)]
    return jnp.where(has, peers, -1).astype(jnp.int32)
