"""Evaluation metrics over masked, batched scores, and the curve plot.

Counterpart of the metrics in ``gossipy_tpu/utils.py`` (classification,
the ±1 linear learners', NMI and RMSE), of its ``plot_evaluation`` and
of its two helpers for code ported from the reference,
``choice_not_n`` and ``params_allclose``. Every metric takes any number of leading axes (the engine passes one
row per node) and reduces only the sample axis; ``mask`` marks real rows
(1.0) against padding (0.0).
"""

from __future__ import annotations

from typing import Optional

import torch


def _safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ok = b > 0
    return torch.where(ok, a / torch.where(ok, b, torch.ones_like(b)),
                       torch.zeros_like(a))


def confusion_matrix(y_true: torch.Tensor, y_pred: torch.Tensor,
                     n_classes: int,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked confusion matrix ``[..., C, C]`` (rows: true class)."""
    oh_t = torch.nn.functional.one_hot(y_true.long(), n_classes).float()
    oh_p = torch.nn.functional.one_hot(y_pred.long(), n_classes).float()
    if mask is not None:
        oh_t = oh_t * mask.unsqueeze(-1)
    return oh_t.transpose(-1, -2) @ oh_p


def accuracy(y_true, y_pred, mask=None):
    ok = (y_true == y_pred).float()
    if mask is None:
        return ok.mean(dim=-1)
    return _safe_div((ok * mask).sum(dim=-1), mask.sum(dim=-1))


def macro_prf1(y_true, y_pred, n_classes: int, mask=None):
    """Macro precision/recall/F1 over all ``n_classes`` classes, a class
    without predicted (resp. true) rows counting 0 (sklearn's
    ``zero_division=0``)."""
    cm = confusion_matrix(y_true, y_pred, n_classes, mask)
    tp = torch.diagonal(cm, dim1=-2, dim2=-1)
    prec = _safe_div(tp, cm.sum(dim=-2))
    rec = _safe_div(tp, cm.sum(dim=-1))
    f1 = _safe_div(2 * prec * rec, prec + rec)
    return prec.mean(dim=-1), rec.mean(dim=-1), f1.mean(dim=-1)


def binary_auc(scores: torch.Tensor, y_true: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ROC-AUC of binary labels by the rank-sum formula with midranks
    (ties share their average rank); 0.5 when a class is absent."""
    scores = scores.float()
    mask = torch.ones_like(scores) if mask is None else mask.float()
    pos = (y_true > 0).float() * mask
    neg = (y_true <= 0).float() * mask
    e = scores.shape[-1]
    # Masked rows sort last, so real rows' ranks are their ranks among
    # real rows alone.
    s = torch.where(mask > 0, scores, torch.full_like(scores, float("inf")))
    s_sorted, order = torch.sort(s, dim=-1)
    pos_sorted = torch.gather(pos, -1, order)
    idx = torch.arange(e, dtype=torch.float32,
                       device=scores.device).expand_as(s_sorted)
    differs = s_sorted[..., 1:] != s_sorted[..., :-1]
    edge = torch.ones_like(differs[..., :1])
    new_grp = torch.cat([edge, differs], dim=-1)
    end_grp = torch.cat([differs, edge], dim=-1)
    grp_first = torch.cummax(torch.where(new_grp, idx, torch.zeros_like(idx)),
                             dim=-1).values
    last_cand = torch.where(end_grp, idx, torch.full_like(idx, e - 1.0))
    grp_last = torch.flip(torch.cummin(torch.flip(last_cand, [-1]), dim=-1)
                          .values, [-1])
    midrank = (grp_first + grp_last) / 2.0 + 1.0
    n_pos = pos.sum(dim=-1)
    n_neg = neg.sum(dim=-1)
    u = (midrank * pos_sorted).sum(dim=-1) - n_pos * (n_pos + 1.0) / 2.0
    auc = _safe_div(u, n_pos * n_neg)
    return torch.where((n_pos > 0) & (n_neg > 0), auc,
                       torch.full_like(auc, 0.5))


def classification_metrics(scores: torch.Tensor, y_true: torch.Tensor,
                           n_classes: int,
                           mask: Optional[torch.Tensor] = None) -> dict:
    """Accuracy and macro precision/recall/F1 of argmax predictions, plus
    ``auc`` from ``scores[..., 1]`` when there are two classes.
    ``scores`` is ``[..., E, C]``; each value is ``[...]``."""
    y_pred = torch.argmax(scores, dim=-1)
    if y_true.dim() == scores.dim():  # one-hot labels
        y_true = torch.argmax(y_true, dim=-1)
    prec, rec, f1 = macro_prf1(y_true, y_pred, n_classes, mask)
    res = {
        "accuracy": accuracy(y_true, y_pred, mask),
        "precision": prec,
        "recall": rec,
        "f1_score": f1,
    }
    if scores.shape[-1] == 2:
        res["auc"] = binary_auc(scores[..., 1], y_true, mask)
    return res


def signed_binary_metrics(scores: torch.Tensor, y_true: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> dict:
    """Metrics of ±1-labelled linear models (AdaLine, Pegasos): the
    prediction is ``score >= 0``, a label is positive when ``> 0``;
    accuracy, macro P/R/F1 over the two classes and the AUC of the raw
    scores. ``scores`` and ``y_true`` are ``[..., E]``."""
    y01 = (y_true > 0).to(torch.int64)
    pred01 = (scores >= 0).to(torch.int64)
    prec, rec, f1 = macro_prf1(y01, pred01, 2, mask)
    return {
        "accuracy": accuracy(y01, pred01, mask),
        "precision": prec,
        "recall": rec,
        "f1_score": f1,
        "auc": binary_auc(scores, y01, mask),
    }


def nmi(y_true: torch.Tensor, y_pred: torch.Tensor, n_true: int,
        n_pred: int, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalized mutual information (arithmetic normalisation, natural
    logarithms: scikit-learn's ``normalized_mutual_info_score``), one
    value per leading index; 0 when both labellings have zero entropy."""
    cm = confusion_matrix(y_true, y_pred, max(n_true, n_pred), mask)
    n = cm.sum(dim=(-2, -1), keepdim=True)
    pij = _safe_div(cm, n.expand_as(cm))
    pi = pij.sum(dim=-1, keepdim=True)
    pj = pij.sum(dim=-2, keepdim=True)
    outer = pi * pj
    ok = (pij > 0) & (outer > 0)
    ratio = _safe_div(pij, torch.where(outer > 0, outer,
                                       torch.ones_like(outer)))
    mi = torch.where(ok, pij * torch.log(torch.where(ok, ratio,
                                                     torch.ones_like(ratio))),
                     torch.zeros_like(pij)).sum(dim=(-2, -1))

    def entropy(p):
        safe = torch.where(p > 0, p, torch.ones_like(p))
        return -torch.where(p > 0, p * torch.log(safe),
                            torch.zeros_like(p)).sum(dim=(-2, -1))
    denom = (entropy(pi) + entropy(pj)) / 2.0
    return torch.where(denom > 0, mi / torch.where(denom > 0, denom,
                                                   torch.ones_like(denom)),
                       torch.zeros_like(denom))


def rmse(pred: torch.Tensor, target: torch.Tensor,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Root mean squared error over the last axis (masked)."""
    err2 = (pred - target) ** 2
    if mask is None:
        return torch.sqrt(err2.mean(dim=-1))
    return torch.sqrt(_safe_div((err2 * mask).sum(dim=-1),
                                mask.sum(dim=-1)))


def choice_not_n(mn: int, mx: int, notn: int,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A uniform random int in ``[mn, mx]`` excluding ``notn``, as a 0-d
    int64 tensor drawn from ``generator``: the JAX package's shift form
    (draw from a range one smaller and step over the excluded value), with
    no rejection loop. A ``notn`` outside the range excludes nothing."""
    if not mn <= notn <= mx:
        return torch.randint(mn, mx + 1, (), generator=generator)
    if mn >= mx:
        raise ValueError(
            f"no value in [{mn}, {mx}] left after excluding {notn}")
    v = torch.randint(mn, mx, (), generator=generator)   # [mn, mx - 1]
    return torch.where(v >= notn, v + 1, v)


def _leaves(tree):
    """``(structure, leaves)`` of nested dicts, lists and tuples (a
    NamedTuple keeps its type) over tensors and arrays."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_leaves(tree[k]) for k in keys]
        return (("dict", tuple(keys), tuple(p[0] for p in parts)),
                [x for p in parts for x in p[1]])
    if isinstance(tree, (list, tuple)):
        parts = [_leaves(v) for v in tree]
        return ((type(tree).__name__, len(tree), tuple(p[0] for p in parts)),
                [x for p in parts for x in p[1]])
    return ("leaf",), [tree]


def params_allclose(p1, p2, rtol: float = 1e-5, atol: float = 1e-7) -> bool:
    """Parameter equality within ``rtol``/``atol`` (the reference's
    ``torch_models_eq``): two tensors, or two nests of dicts, lists and
    tuples of tensors or arrays; False when the structures or a shape
    differ."""
    s1, l1 = _leaves(p1)
    s2, l2 = _leaves(p2)
    if s1 != s2:
        return False
    for a, b in zip(l1, l2):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        if a.shape != b.shape:
            return False
        if not torch.allclose(a.to(torch.float64).cpu(),
                              b.to(torch.float64).cpu(), rtol=rtol,
                              atol=atol):
            return False
    return True


def plot_evaluation(evals: list, title: str = "Untitled plot",
                    path: Optional[str] = None):
    """Mean and standard-deviation band of each metric over repetitions:
    ``evals`` holds one list of per-round ``{metric: value}`` dicts per
    repetition. Saved to ``path`` when given (matplotlib, imported
    here)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    if not evals or not evals[0] or not evals[0][0]:
        return None
    fig = plt.figure()
    for k in evals[0][0]:
        series = np.array([[d[k] for d in rep] for rep in evals],
                          dtype=float)
        mu, sd = series.mean(axis=0), series.std(axis=0)
        plt.fill_between(range(1, len(mu) + 1), mu - sd, mu + sd, alpha=0.2)
        plt.plot(range(1, len(mu) + 1), mu, label=k)
    plt.legend(loc="lower right")
    plt.title(title)
    plt.xlabel("round")
    if path:
        plt.savefig(path, bbox_inches="tight")
    return fig
