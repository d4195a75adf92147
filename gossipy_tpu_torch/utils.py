"""Evaluation metrics over masked, batched scores.

Counterpart of the classification metrics in ``gossipy_tpu/utils.py``.
Every function takes any number of leading axes (the engine passes one
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
