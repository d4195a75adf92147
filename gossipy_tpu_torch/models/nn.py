"""Models over stacked per-node parameters.

Counterpart of ``gossipy_tpu/models/nn.py``. The JAX engine vmaps one flax
module over the node axis; here a model's forward takes every node's
parameters at once (each leaf ``[N, ...]``) and inputs ``[N, B, ...]``, and
batches over the node axis itself (``torch.bmm``).

Parameters keep the JAX package's names and layouts, so converting a flax
tree is a flatten with no transposes (:mod:`gossipy_tpu_torch.convert`):

- ``Dense_i/kernel`` is ``[in, out]`` and the layer computes ``x @ W + b``;
- ``Conv_i/kernel`` is HWIO ``[3, 3, C, O]``; the convolution is im2col
  with the patch axis in ``(i, j, c)`` row-major order, so the kernel
  reshapes to ``[9 C, O]`` — the JAX default ``conv_impl="einsum"``.

Images stay NHWC throughout, so the flatten before the first dense layer
runs in ``(h, w, c)`` order as in the JAX model.

A node's parameters live in ONE flat float32 row (:class:`ParamLayout`);
each leaf is a view into it. The row stride is padded to a multiple of 4
floats so that every row starts 16-byte aligned for the merge kernel's
vector loads; the padding columns stay zero.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

# Row strides are padded to this many float32 values (16 bytes).
ROW_ALIGN = 4


class ParamLayout:
    """Where each named leaf lives in a node's flat parameter row.

    ``leaves`` is a list of ``(name, shape)`` in the JAX package's pytree
    order (flax sorts keys). ``width`` is the number of real scalars,
    ``stride`` the padded row length.
    """

    def __init__(self, leaves):
        self.leaves = [(name, tuple(shape)) for name, shape in leaves]
        self.offsets = {}
        off = 0
        for name, shape in self.leaves:
            self.offsets[name] = off
            off += math.prod(shape)
        self.width = off
        self.stride = -(-off // ROW_ALIGN) * ROW_ALIGN

    def views(self, flat: torch.Tensor) -> dict:
        """Leaf views into ``flat`` (``[..., stride]``): each
        ``[..., *shape]``, sharing ``flat``'s storage."""
        lead = flat.shape[:-1]
        out = {}
        for name, shape in self.leaves:
            o = self.offsets[name]
            out[name] = flat[..., o:o + math.prod(shape)].view(tuple(lead) + shape)
        return out

    def flatten(self, leaves: dict) -> torch.Tensor:
        """Pack ``{name: [..., *shape]}`` into a new ``[..., stride]`` row
        with zero padding."""
        first = leaves[self.leaves[0][0]]
        lead = first.shape[:first.dim() - len(self.leaves[0][1])]
        flat = torch.zeros(*lead, self.stride, dtype=torch.float32,
                           device=first.device)
        for name, shape in self.leaves:
            o = self.offsets[name]
            flat[..., o:o + math.prod(shape)] = \
                leaves[name].reshape(*lead, -1)
        return flat


class RowDraws:
    """Stands in for a generator while a model's ``init`` runs once for a
    block of nodes (:func:`init_rows`): each draw takes its columns of the
    ``[b, count]`` uniforms ``u`` in order, so the block's row ``i`` holds
    what the ``i``-th of ``b`` inits drawn one after another would hold.
    With ``u`` None (the counting pass) a draw counts its values and
    dtype and returns zeros."""

    def __init__(self, u: Optional[torch.Tensor] = None):
        self.u = u
        self.count = 0
        self.dtypes = set()

    def take(self, shape, dtype) -> torch.Tensor:
        n = math.prod(shape)
        self.dtypes.add(dtype)
        lo, self.count = self.count, self.count + n
        if self.u is None:
            return torch.zeros(shape, dtype=dtype)
        return self.u[:, lo:lo + n].reshape((self.u.shape[0],) + tuple(shape))


def _uniform(shape, generator, dtype) -> torch.Tensor:
    """``torch.rand`` under ``generator``, or a block's columns when it is
    a :class:`RowDraws`."""
    if isinstance(generator, RowDraws):
        return generator.take(shape, dtype)
    return torch.rand(shape, generator=generator, dtype=dtype)


def _xavier_uniform(shape, fan_in, fan_out, generator):
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = _uniform(shape, generator, torch.float32)
    return (2.0 * u - 1.0) * limit


# The standard normal CDF at -2 and 2: the truncation bounds of flax's
# truncated normal, as probabilities.
_PHI_LO = 0.5 * math.erfc(math.sqrt(2.0))
_PHI_HI = 1.0 - _PHI_LO


def _lecun_normal(shape, fan_in, generator):
    """flax's default Dense init: a normal truncated at two standard
    deviations, rescaled so the variance is ``1 / fan_in``.

    Drawn by the inverse CDF in the module itself: one float64 uniform
    per value mapped into ``[Phi(-2), Phi(2)]``, then ``erfinv`` and the
    scale ``std * sqrt(2)``. No rejection loop and no algorithm of the
    torch release, so one seed gives the same weights on every
    installation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    u = _uniform(shape, generator, torch.float64)
    p = _PHI_LO + (_PHI_HI - _PHI_LO) * u
    z = torch.erfinv(2.0 * p - 1.0) * (std * math.sqrt(2.0))
    return z.to(torch.float32)


def param_count(params: dict) -> int:
    """Total number of scalars in a model's ``{name: tensor}`` parameters
    (its ``init``), as the JAX package counts a pytree's leaves; a flat
    row's padding columns are not parameters (``ParamLayout.width``)."""
    return sum(int(t.numel()) for t in params.values())


def _dense(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor):
    """``x [N, B, in] @ kernel [N, in, out] + bias [N, out]``."""
    return torch.baddbmm(bias.unsqueeze(1), x, kernel)


def im2col_valid(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """VALID im2col of NHWC images ``[..., H, W, C]`` to
    ``[..., Ho, Wo, kh*kw*C]``, patch axis in ``(i, j, c)`` row-major
    order (the flattening of an HWIO kernel)."""
    ho = x.shape[-3] - kh + 1
    wo = x.shape[-2] - kw + 1
    cols = [x[..., i:i + ho, j:j + wo, :]
            for i in range(kh) for j in range(kw)]
    return torch.cat(cols, dim=-1)


def _conv3x3(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor):
    """Per-node 3x3 VALID convolution: ``x [N, B, H, W, C]``,
    ``kernel [N, 3, 3, C, O]`` -> ``[N, B, H-2, W-2, O]``."""
    n, b, h, w, c = x.shape
    o = kernel.shape[-1]
    patches = im2col_valid(x, 3, 3).reshape(n, b * (h - 2) * (w - 2), 9 * c)
    y = _dense(patches, kernel.reshape(n, 9 * c, o), bias)
    return y.reshape(n, b, h - 2, w - 2, o)


def _max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 VALID max-pool over NHWC ``[N, B, H, W, C]``."""
    n, b, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    x = x[:, :, :2 * h2, :2 * w2, :].reshape(n, b, h2, 2, w2, 2, c)
    return x.amax(dim=(3, 5))


class LogisticRegression:
    """``sigmoid(x @ W + b)`` with ``output_dim`` outputs."""

    def __init__(self, input_dim: int, output_dim: int):
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.leaves = [("Dense_0/bias", (output_dim,)),
                       ("Dense_0/kernel", (input_dim, output_dim))]

    def init(self, generator: torch.Generator) -> dict:
        return {"Dense_0/bias": torch.zeros(self.output_dim),
                "Dense_0/kernel": _lecun_normal(
                    (self.input_dim, self.output_dim), self.input_dim,
                    generator)}

    def forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """``x [N, B, input_dim]`` -> ``[N, B, output_dim]``."""
        return torch.sigmoid(_dense(x, params["Dense_0/kernel"],
                                    params["Dense_0/bias"]))


def _dense_leaves(name: str, fan_in: int, fan_out: int, use_bias=True):
    leaves = [(f"{name}/kernel", (fan_in, fan_out))]
    return leaves + ([(f"{name}/bias", (fan_out,))] if use_bias else [])


class Perceptron:
    """``sigmoid(x @ W + b)`` with one output, ``[N, B, 1]``; an
    xavier-uniform kernel, a zero bias (none with ``use_bias=False``)."""

    def __init__(self, dim: int, use_bias: bool = True):
        self.dim = dim
        self.use_bias = use_bias
        self.leaves = sorted(_dense_leaves("Dense_0", dim, 1, use_bias))

    def init(self, generator: torch.Generator) -> dict:
        out = {"Dense_0/kernel": _xavier_uniform((self.dim, 1), self.dim, 1,
                                                 generator)}
        if self.use_bias:
            out["Dense_0/bias"] = torch.zeros(1)
        return out

    def forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """``x [N, B, dim]`` -> ``[N, B, 1]``."""
        h = torch.bmm(x, params["Dense_0/kernel"])
        if self.use_bias:
            h = h + params["Dense_0/bias"].unsqueeze(1)
        return torch.sigmoid(h)


class MLP:
    """Dense layers of ``hidden_dims`` widths, each followed by
    ``activation``, then a linear output layer (raw scores);
    xavier-uniform kernels, zero biases."""

    def __init__(self, input_dim: int, output_dim: int,
                 hidden_dims=(100,), activation=torch.relu):
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.activation = activation
        dims = [input_dim, *hidden_dims, output_dim]
        self._layers = [(f"Dense_{i}", dims[i], dims[i + 1])
                        for i in range(len(dims) - 1)]
        self.leaves = sorted(leaf for name, i, o in self._layers
                             for leaf in _dense_leaves(name, i, o))

    def init(self, generator: torch.Generator) -> dict:
        out = {}
        for name, i, o in self._layers:
            out[f"{name}/kernel"] = _xavier_uniform((i, o), i, o, generator)
            out[f"{name}/bias"] = torch.zeros(o)
        return out

    def forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """``x [N, B, input_dim]`` -> ``[N, B, output_dim]``."""
        for name, _, _ in self._layers[:-1]:
            x = self.activation(_dense(x, params[f"{name}/kernel"],
                                       params[f"{name}/bias"]))
        name = self._layers[-1][0]
        return _dense(x, params[f"{name}/kernel"], params[f"{name}/bias"])


class LinearRegression:
    """``x @ W + b`` with ``output_dim`` outputs; a lecun-normal kernel
    (flax's ``Dense`` default), a zero bias."""

    def __init__(self, input_dim: int, output_dim: int):
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.leaves = sorted(_dense_leaves("Dense_0", input_dim, output_dim))

    def init(self, generator: torch.Generator) -> dict:
        return {"Dense_0/bias": torch.zeros(self.output_dim),
                "Dense_0/kernel": _lecun_normal(
                    (self.input_dim, self.output_dim), self.input_dim,
                    generator)}

    def forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """``x [N, B, input_dim]`` -> ``[N, B, output_dim]``."""
        return _dense(x, params["Dense_0/kernel"], params["Dense_0/bias"])


class AdaLine:
    """The AdaLine / Pegasos weight vector: a zero-initialised ``[dim]``
    row, trained by hand-written rules (:mod:`..handlers.linear`), no
    autograd. The JAX params are a bare array, one leaf whose name is the
    empty path ``""``."""

    def __init__(self, dim: int):
        self.dim = dim
        self.leaves = [("", (dim,))]

    def init(self, generator: Optional[torch.Generator] = None) -> dict:
        return {"": torch.zeros(self.dim)}

    def forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Scores ``x [N, B, dim] @ w`` -> ``[N, B]``."""
        return torch.bmm(x, params[""].unsqueeze(-1)).squeeze(-1)


class CIFAR10Net:
    """The small CIFAR-10 CNN, NHWC: conv(3->32) -> pool -> conv(32->64)
    -> pool -> conv(64->64) -> pool -> fc(256->64) -> fc(64->10), 3x3
    VALID convolutions and 2x2 max-pools (32->30->15->13->6->4->2)."""

    _CONVS = (("Conv_0", 3, 32), ("Conv_1", 32, 64), ("Conv_2", 64, 64))

    def __init__(self, n_classes: int = 10):
        self.n_classes = n_classes
        self._denses = (("Dense_0", 256, 64), ("Dense_1", 64, n_classes))
        leaves = []
        for name, c, o in self._CONVS:
            leaves += [(f"{name}/bias", (o,)), (f"{name}/kernel", (3, 3, c, o))]
        for name, i, o in self._denses:
            leaves += [(f"{name}/bias", (o,)), (f"{name}/kernel", (i, o))]
        self.leaves = sorted(leaves)

    def init(self, generator: torch.Generator) -> dict:
        """xavier-uniform kernels (fans over the 3x3 receptive field for the
        convolutions), zero biases."""
        out = {}
        for name, c, o in self._CONVS:
            out[f"{name}/kernel"] = _xavier_uniform((3, 3, c, o), 9 * c,
                                                    9 * o, generator)
            out[f"{name}/bias"] = torch.zeros(o)
        for name, i, o in self._denses:
            out[f"{name}/kernel"] = _xavier_uniform((i, o), i, o, generator)
            out[f"{name}/bias"] = torch.zeros(o)
        return out

    def forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """``x [N, B, 32, 32, 3]`` (or NCHW ``[N, B, 3, 32, 32]``) ->
        logits ``[N, B, n_classes]``."""
        if x.shape[-1] != 3 and x.shape[2] == 3:
            x = x.permute(0, 1, 3, 4, 2)
        for name, _, _ in self._CONVS:
            x = torch.relu(_conv3x3(x, params[f"{name}/kernel"],
                                    params[f"{name}/bias"]))
            x = _max_pool2(x)
        x = x.reshape(x.shape[0], x.shape[1], -1)
        x = torch.relu(_dense(x, params["Dense_0/kernel"],
                              params["Dense_0/bias"]))
        return _dense(x, params["Dense_1/kernel"], params["Dense_1/bias"])


def init_flat(model, layout: ParamLayout, generator: Optional[torch.Generator]
              ) -> torch.Tensor:
    """One node's initial parameters as a flat ``[stride]`` CPU row."""
    g = generator if generator is not None else torch.Generator()
    return layout.flatten(model.init(g))


def init_rows(model, layout: ParamLayout, b: int, draw
              ) -> Optional[torch.Tensor]:
    """``b`` nodes' initial parameters at once, ``[b, stride]`` on the
    host: ``model.init`` runs once over a :class:`RowDraws` whose
    uniforms ``draw(count, dtype)`` gives as ``[b, count]``, every value
    transformed elementwise as one init transforms it. With ``draw`` =
    ``torch.rand((b, count), generator=g, dtype=dtype)`` the rows equal
    ``b`` calls of :func:`init_flat` under ``g``, bit for bit (a CPU
    generator draws serially). None when the model's draws mix dtypes
    (their order in one stream could not be cut into columns)."""
    probe = RowDraws()
    model.init(probe)
    if len(probe.dtypes) > 1:
        return None
    dtype = probe.dtypes.pop() if probe.dtypes else torch.float32
    leaves = model.init(RowDraws(draw(probe.count, dtype)))
    shapes = dict(layout.leaves)
    return layout.flatten({
        k: v if v.dim() > len(shapes[k]) else v.expand(b, *shapes[k])
        for k, v in leaves.items()})
