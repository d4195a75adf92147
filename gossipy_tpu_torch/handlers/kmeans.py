"""Online gossip k-means (Berta 2014).

Counterpart of ``gossipy_tpu/handlers/kmeans.py``. A node's params are
its ``[k, dim]`` centroids, one bare-array leaf. ``update`` moves each
centroid toward the mean of the node's samples assigned to it;
``merge`` averages own and received centroids, either index by index
(``matching="naive"``) or after matching each own centroid to a received
one (``"hungarian"``).

The matching follows the JAX package's dispatch: the engine's merges, of
stacked rows ``[N, stride]``, take :func:`greedy_match` (batched over the
rows, on the device, as the JAX engine's traced merges do); a merge of
one unstacked pair ``[stride]`` (the JAX package's eager call) takes the
exact assignment of :func:`exact_match` on the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..core import CreateModelMode
from ..models.nn import ParamLayout
from ..utils import nmi
from .base import BaseHandler, ModelState, PeerModel


def greedy_match(cost: torch.Tensor) -> torch.Tensor:
    """Greedy linear assignment of ``cost [..., k, k]``: k times take the
    cheapest remaining (row, column) pair, ties to the first flat index as
    ``jnp.argmin`` breaks them. Returns each row's column, int64
    ``[..., k]``. Exact when each centroid's partner is its global
    nearest; on crafted costs it can be far from the optimum."""
    k = cost.shape[-1]
    lead = cost.shape[:-2]
    c = cost.reshape(-1, k, k).clone()
    m = c.shape[0]
    rows = torch.arange(m, device=c.device)
    match = torch.zeros((m, k), dtype=torch.int64, device=c.device)
    for _ in range(k):
        flat = torch.argmin(c.reshape(m, k * k), dim=1)
        r, col = flat // k, flat % k
        match[rows, r] = col
        c[rows, r, :] = float("inf")
        c[rows, :, col] = float("inf")
    return match.reshape(*lead, k)


def exact_match(cost) -> np.ndarray:
    """Exact minimum-cost assignment of one ``[k, k]`` cost (scipy's
    ``linear_sum_assignment``, on the host): each row's column, int32
    ``[k]``."""
    from scipy.optimize import linear_sum_assignment
    c = cost.detach().cpu().numpy() if isinstance(cost, torch.Tensor) \
        else np.asarray(cost)  # tracelint: disable=np-in-round
    rows, cols = linear_sum_assignment(c)
    out = np.zeros(c.shape[0], dtype=np.int32)
    out[rows] = cols.astype(np.int32)
    return out


class KMeansHandler(BaseHandler):
    """Online k-means with mean-of-assigned centroid moves and averaged
    merges (age = max)."""

    def __init__(self, k: int, dim: int, alpha: float = 0.1,
                 matching: str = "naive",
                 create_model_mode: CreateModelMode = CreateModelMode.UPDATE):
        if matching not in ("naive", "hungarian"):
            raise ValueError(f"invalid matching method {matching!r}")
        self.k = k
        self.dim = dim
        self.alpha = alpha
        self.matching = matching
        self.mode = create_model_mode
        self.layout = ParamLayout([("", (k, dim))])

    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> ModelState:
        """Centroids uniform in ``[0, 1)``, age 0."""
        dev = resolve_device(device)
        g = generator if generator is not None else torch.Generator()
        c = torch.rand((self.k, self.dim), generator=g)
        return ModelState(self.layout.flatten({"": c}).to(dev), (),
                          torch.zeros((), dtype=torch.int32, device=dev))

    def _centroids(self, params: torch.Tensor) -> torch.Tensor:
        return self.layout.views(params)[""]

    @staticmethod
    def _assign(c: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
        """Nearest centroid of each sample: ``c [N, k, dim]``, ``X [N, S,
        dim]`` -> ``[N, S]``."""
        d2 = ((X[:, :, None, :] - c[:, None, :, :]) ** 2).sum(dim=-1)
        return torch.argmin(d2, dim=-1)

    def update(self, state: ModelState, data, perms=None) -> ModelState:
        """Each centroid with assigned samples moves a share ``alpha``
        toward their mean; the age grows by one. Draws nothing."""
        X, _, mask = data
        c = self._centroids(state.params)
        idx = self._assign(c, X)
        onehot = torch.nn.functional.one_hot(idx, self.k).to(X.dtype) \
            * mask[..., None]
        counts = onehot.sum(dim=1)
        sums = torch.bmm(onehot.transpose(1, 2), X)
        means = sums / torch.clamp(counts, min=1.0)[..., None]
        moved = c * (1 - self.alpha) + self.alpha * means
        c = torch.where((counts > 0)[..., None], moved, c)
        return ModelState(self.layout.flatten({"": c}), (),
                          state.n_updates + 1)

    def merge(self, state: ModelState, peer: PeerModel) -> ModelState:
        """``(own + matched received) / 2``: greedy matching on stacked
        rows, exact on one unstacked pair (module doc)."""
        c1 = self._centroids(state.params)
        c2 = self._centroids(peer.params)
        if self.matching == "naive":
            c = (c1 + c2) / 2.0
        else:
            d2 = ((c1[..., :, None, :] - c2[..., None, :, :]) ** 2).sum(-1)
            cost = torch.sqrt(d2)
            if cost.dim() == 2:
                match = torch.as_tensor(exact_match(cost),
                                        device=cost.device).long()
                c = (c1 + c2[match]) / 2.0
            else:
                match = greedy_match(cost)
                c = (c1 + torch.gather(
                    c2, 1, match[..., None].expand_as(c2))) / 2.0
        return ModelState(self.layout.flatten({"": c}), (),
                          torch.maximum(state.n_updates, peer.n_updates))

    @torch.no_grad()
    def evaluate(self, state: ModelState, data) -> dict:
        """NMI between the labels and the nearest-centroid clusters, one
        value per node."""
        X, y, mask = data
        y_pred = self._assign(self._centroids(state.params), X)
        return {"nmi": nmi(y.long(), y_pred, self.k, self.k, mask)}

    def get_size(self) -> int:
        return self.k * self.dim
