"""Carry the JAX package's parameters and optimizer state over to the port.

The port keeps the JAX layouts (HWIO convolution kernels, ``[in, out]``
dense kernels), so a flax parameter tree maps onto the port's named leaves
by name alone: ``{"Conv_0": {"kernel": ..., "bias": ...}, ...}`` becomes
``{"Conv_0/kernel": ..., "Conv_0/bias": ...}``, then one flat row per node.
An optax state maps onto the port's flat state tuple
(:mod:`gossipy_tpu_torch.optim`) in the order its rules chain. The arrays
come in as numpy (``np.asarray`` of each JAX leaf, which keeps optax's
named tuples); nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.nn import ParamLayout


def flatten_names(tree, prefix: str = "") -> dict:
    """``{"Dense_0": {"kernel": a}}`` -> ``{"Dense_0/kernel": a}``; a bare
    array (AdaLine's vector, k-means' centroids) is the one leaf named by
    the empty path, ``{"": a}``."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_names(v, name))
        else:
            out[name] = v
    return out


def params_from_jax(tree, layout: ParamLayout, stacked: bool = True,
                    device="cpu") -> torch.Tensor:
    """A (stacked) flax parameter tree of numpy arrays -> the port's flat
    rows: ``[N, stride]`` when ``stacked`` (leaves ``[N, ...]``), else
    ``[stride]``. Raises when a leaf is missing, extra or misshapen."""
    named = flatten_names(tree)
    want = {name for name, _ in layout.leaves}
    if set(named) != want:
        raise ValueError(f"leaf names differ: got {sorted(named)}, "
                         f"want {sorted(want)}")
    leaves = {}
    for name, shape in layout.leaves:
        a = np.asarray(named[name], dtype=np.float32)
        got = a.shape[1:] if stacked else a.shape
        if tuple(got) != shape:
            raise ValueError(f"{name}: shape {a.shape}, want "
                             f"{'[N] + ' if stacked else ''}{list(shape)}")
        leaves[name] = torch.from_numpy(a.copy())
    return layout.flatten(leaves).to(device)


def params_to_numpy(flat: torch.Tensor, layout: ParamLayout) -> dict:
    """The port's flat rows -> ``{name: numpy array}`` in the JAX layouts
    (for holding a port run against a JAX one)."""
    return {k: v.detach().cpu().numpy() for k, v in layout.views(flat).items()}


def opt_state_from_jax(state, layout: ParamLayout, rule, stacked: bool = True,
                       device="cpu") -> tuple:
    """An optax state of numpy leaves (``jax.tree.map(np.asarray, s)``) ->
    the port's state tuple for the optimizer ``rule``: an ``EmptyState``
    gives nothing, a ``TraceState`` its trace as flat rows, a
    ``ScaleByAdamState`` its int32 ``count`` (``[N]`` when ``stacked``)
    and its ``mu`` and ``nu`` rows; a chain's tuple gives its members' in
    order. Raises on any other state, or when the result does not have
    ``rule``'s length."""
    out = []

    def rows(tree):
        return params_from_jax(tree, layout, stacked, device)

    def walk(node):
        fields = getattr(node, "_fields", None)
        if fields is None:
            if not isinstance(node, (tuple, list)):
                raise ValueError(f"unknown optimizer state {node!r}")
            for child in node:
                walk(child)
        elif fields == ():
            pass
        elif fields == ("trace",):
            out.append(rows(node.trace))
        elif fields == ("count", "mu", "nu"):
            out.append(torch.tensor(np.asarray(node.count, np.int32),
                                    device=device))
            out.extend([rows(node.mu), rows(node.nu)])
        else:
            raise ValueError(f"{type(node).__name__}{fields} has no "
                             "counterpart in the port's optimizers")

    walk(state)
    if len(out) != rule.n_state:
        raise ValueError(f"the state gives {len(out)} tensors, the rule "
                         f"keeps {rule.n_state}")
    return tuple(out)
