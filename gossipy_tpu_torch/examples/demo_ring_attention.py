"""Ring-attention training demo on one card: the twin of
``examples/demo_ring_attention.py``.

Trains a one-layer attention model on a retrieval task: every position
must attend back to the sequence start and reproduce its content, which
only attention can solve. The JAX demo shards the sequence over a ring of
devices (re-executing under a virtual CPU mesh when fewer are attached);
``--devices N`` runs the same ring over a virtual mesh of N positions on
the one device (:func:`gossipy_tpu_torch.parallel.collectives.
ring_attention`, K5 on every hop: N² launches a forward on the card). On a
ring of one device that is one hop over the whole sequence, i.e.
:func:`gossipy_tpu_torch.ops.flash_attention` with ``causal=False``, one
K5 launch a forward. Gradients go through the hop's hand-derived backward; the optimizer
is :func:`gossipy_tpu_torch.optim.adam` (0.02), as the JAX demo's
``optax.adam``.

Run: ``python -m gossipy_tpu_torch.examples.demo_ring_attention
[--devices 1] [--seq-len 256] [--dim 32] [--steps 60] [--seed 42]
[--device cpu]``. It
runs on ``cuda`` unless given ``--device cpu`` and prints one JSON line.
The task data come from ``numpy.random.default_rng(seed)`` as in the JAX
demo; the initial weights come from the same generator (the JAX demo draws
them with ``jax.random``), so the losses match the JAX demo's only when
its weights are passed in through :func:`params_from_numpy`.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from gossipy_tpu_torch import resolve_device
from gossipy_tpu_torch.ops import flash_attention
from gossipy_tpu_torch.optim import adam, apply_updates


def make_task(seq_len: int, dim: int, seed: int):
    """The retrieval task as the JAX demo makes it: ``x`` ``[S, D]`` from
    ``default_rng(seed)`` and the target ``x[0]`` at every position."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(seq_len, dim)).astype(np.float32)
    tgt = np.broadcast_to(x[0], (seq_len, dim)).copy()
    return x, tgt, rng


def init_params(dim: int, rng: np.random.Generator) -> dict:
    """``{wq, wk, wv}`` ``[D, D]`` (the ``x @ W`` layout), normal times
    ``1/sqrt(D)`` as in the JAX demo, drawn from ``rng``."""
    scale = 1.0 / np.sqrt(dim)
    return {name: (rng.normal(size=(dim, dim)) * scale).astype(np.float32)
            for name in ("wq", "wk", "wv")}


def params_from_numpy(params: dict, device=None) -> dict:
    """The JAX demo's ``{wq, wk, wv}`` as numpy arrays (``x @ W`` layout,
    no transpose) to float32 tensors on ``device``."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(params[k], np.float32), device=dev)
            for k in ("wq", "wk", "wv")}


def loss_fn(params: dict, x: torch.Tensor, tgt: torch.Tensor,
            attention=flash_attention) -> torch.Tensor:
    """Mean squared error of one attention layer's output against the
    target. ``attention`` is the attention function (the default launches
    K5 on the card)."""
    out = attention(x @ params["wq"], x @ params["wk"], x @ params["wv"],
                    causal=False)
    return torch.mean((out - tgt) ** 2)


def train(params: dict, x: torch.Tensor, tgt: torch.Tensor, steps: int,
          lr: float = 0.02, attention=flash_attention, log_every: int = 0):
    """``steps`` adam steps from ``params``; returns the loss of each step
    (taken before its update, as the JAX demo's) and the final params."""
    opt = adam(lr)
    state = opt.init(params)
    losses = []
    for i in range(steps):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        loss = loss_fn(leaves, x, tgt, attention)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        updates, state = opt.update(dict(zip(leaves, grads)), state)
        params = apply_updates(params, updates)
        losses.append(float(loss.detach()))
        if log_every and i % log_every == 0:
            print(f"step {i:3d}  loss {losses[-1]:.4f}", file=sys.stderr)
    return losses, params


def ring_attention_on(devices: int, device) -> callable:
    """The attention function of a ring of ``devices`` positions on
    ``device`` (a virtual mesh): :func:`flash_attention` for one."""
    if devices == 1:
        return flash_attention
    from gossipy_tpu_torch.parallel import make_mesh
    from gossipy_tpu_torch.parallel.collectives import ring_attention
    mesh = make_mesh(devices, devices=[device] * devices)

    def attention(q, k, v, causal=False):
        return ring_attention(q, k, v, mesh, causal=causal, flash=True)
    return attention


def run(seq_len: int = 256, dim: int = 32, steps: int = 60, seed: int = 42,
        devices: int = 1, device=None, log_every: int = 0) -> dict:
    """The demo; returns its JSON record."""
    if devices < 1 or seq_len % devices:
        raise ValueError(f"--devices {devices} must divide --seq-len "
                         f"{seq_len}")
    dev = resolve_device(device)
    x_np, tgt_np, rng = make_task(seq_len, dim, seed)
    params = params_from_numpy(init_params(dim, rng), dev)
    x = torch.as_tensor(x_np, device=dev)
    tgt = torch.as_tensor(tgt_np, device=dev)
    losses, _ = train(params, x, tgt, steps,
                      attention=ring_attention_on(devices, dev),
                      log_every=log_every)
    return {
        "demo": "ring_attention_training",
        "devices": devices,
        "seq_len": seq_len,
        "per_device_kv_rows": seq_len // devices,
        "loss_first": round(losses[0], 4),
        "loss_last": round(losses[-1], 4),
        "learned": losses[-1] < 0.5 * losses[0],
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--devices", type=int, default=1,
                        help="ring size: a virtual mesh of this many "
                        "positions on the one device")
    parser.add_argument("--seq-len", type=int, default=256)
    parser.add_argument("--dim", type=int, default=32)
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    print(json.dumps(run(args.seq_len, args.dim, args.steps, args.seed,
                         args.devices, args.device, log_every=10)))


if __name__ == "__main__":
    main()
