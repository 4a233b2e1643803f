"""Evaluation metrics (``msha_gnn_tpu/training/metrics.py``): the flow
models' classification report, in torch on the scores' device, and the
link-prediction metrics ``hits_at_k`` and the binary AUC
(``msha_gnn_tpu/training/kd.py::_binary_auc_np``).

The conventions are the JAX package's: tied scores share their mean rank;
a class absent from the labels, or with no negatives, leaves the macro
AUC's mean; precision and recall take ``zero_division=1``; ``f1`` is
``2pr / (p + r)`` unguarded.
"""

from __future__ import annotations

import numpy as np
import torch


def accuracy(pred_labels: torch.Tensor, true_labels: torch.Tensor
             ) -> torch.Tensor:
    return (pred_labels == true_labels).float().mean()


def _mean_ranks(scores: torch.Tensor) -> torch.Tensor:
    """The 1-based ranks of ``scores`` along dim 0 (each column on its
    own), tied scores sharing the mean of their ranks; float64."""
    n = scores.shape[0]
    sorted_s, order = torch.sort(scores, dim=0)
    pos = torch.arange(n, device=scores.device)
    pos = pos.view(n, *([1] * (scores.dim() - 1))).expand_as(scores)
    starts = torch.ones_like(sorted_s, dtype=torch.bool)
    starts[1:] = sorted_s[1:] != sorted_s[:-1]
    ends = torch.ones_like(starts)
    ends[:-1] = starts[1:]
    # each slot's run of equal scores: its first slot (a running max of the
    # run starts) and its last (a running min, from the end, of the ends)
    first = torch.where(starts, pos, 0).cummax(dim=0).values
    last = torch.where(ends, pos, n).flip(0).cummin(dim=0).values.flip(0)
    mean_rank = (first + last).double() / 2.0 + 1.0
    return torch.empty_like(mean_rank).scatter_(0, order, mean_rank)


def _auc_from_ranks(ranks: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Rank-sum AUC of the columns of ``ranks`` against the 0/1 columns of
    ``pos``; nan where a column has no positive or no negative."""
    p = pos.sum(dim=0)
    neg = pos.shape[0] - p
    auc = ((ranks * pos).sum(dim=0) - p * (p + 1) / 2.0) \
        / (p * neg).clamp_min(1.0)
    return torch.where((p > 0) & (neg > 0), auc, torch.nan)


def _binary_auc(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Rank-based ROC-AUC of one binary column,
    ``(sum of positive ranks - P(P+1)/2) / (P N)``; nan without both
    classes."""
    return _auc_from_ranks(_mean_ranks(scores), labels.double()).float()


def multiclass_auc(scores: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """Macro one-vs-rest ROC-AUC over the score columns: each class's AUC,
    averaged over the classes that have positives and negatives (0 when
    none has)."""
    m = scores.shape[1]
    pos = (labels.long()[:, None]
           == torch.arange(m, device=scores.device)).double()
    per_class = _auc_from_ranks(_mean_ranks(scores), pos)
    valid = ~torch.isnan(per_class)
    return (torch.where(valid, per_class, 0.0).sum()
            / valid.sum().clamp_min(1)).float()


def precision_recall(pred_labels: torch.Tensor, true_labels: torch.Tensor,
                     num_classes: int, average: str):
    """Macro or micro precision and recall with ``zero_division=1``: a
    class never predicted (never present) has precision (recall) 1."""
    pred, true = pred_labels.long(), true_labels.long()
    hit = pred == true
    tp = torch.bincount(true[hit], minlength=num_classes).float()
    pred_cnt = torch.bincount(pred, minlength=num_classes).float()
    true_cnt = torch.bincount(true, minlength=num_classes).float()
    if average == "micro":
        return (tp.sum() / pred_cnt.sum().clamp_min(1.0),
                tp.sum() / true_cnt.sum().clamp_min(1.0))
    if average != "macro":
        raise ValueError(f"average must be 'macro' or 'micro', not "
                         f"{average!r}")
    prec = torch.where(pred_cnt > 0, tp / pred_cnt.clamp_min(1.0), 1.0)
    rec = torch.where(true_cnt > 0, tp / true_cnt.clamp_min(1.0), 1.0)
    return prec.mean(), rec.mean()


def f1(precision: torch.Tensor, recall: torch.Tensor) -> torch.Tensor:
    """``2pr / (p + r)``, nan where both are 0, as the JAX package gives."""
    return 2.0 * precision * recall / (precision + recall)


def classification_report(scores: torch.Tensor, labels: torch.Tensor
                          ) -> dict:
    """The per-epoch metric block of ``scores`` [B, M] (log-)scores and
    ``labels`` [B]: 0-d tensors on the scores' device under the JAX
    package's keys."""
    m = scores.shape[1]
    pred = scores.argmax(dim=1)
    p_mac, r_mac = precision_recall(pred, labels, m, "macro")
    p_mic, r_mic = precision_recall(pred, labels, m, "micro")
    return {
        "auc": multiclass_auc(scores, labels),
        "accuracy": accuracy(pred, labels.long()),
        "precision_macro": p_mac,
        "recall_macro": r_mac,
        "f1_macro": f1(p_mac, r_mac),
        "precision_micro": p_mic,
        "recall_micro": r_mic,
        "f1_micro": f1(p_mic, r_mic),
    }


def hits_at_k(pos_scores: torch.Tensor, neg_scores: torch.Tensor,
              k: int) -> torch.Tensor:
    """OGB Hits@K: the fraction of positives scoring strictly above the
    k-th highest negative; 1.0 with fewer than k negatives, as OGB's
    evaluator gives."""
    if neg_scores.shape[0] < k:
        return torch.ones((), device=pos_scores.device)
    kth = torch.topk(neg_scores, k).values[-1]
    return (pos_scores > kth).float().mean()


def binary_auc(pos: np.ndarray, neg: np.ndarray) -> float:
    """ROC AUC of positives against negatives by the rank-sum statistic,
    tied scores sharing their mean rank; nan without both classes."""
    scores = np.concatenate([pos, neg])
    labels = np.concatenate([np.ones_like(pos), np.zeros_like(neg)])
    order = np.argsort(scores)
    s_sorted = scores[order]
    # the 1-based ranks of each run of tied scores, averaged over the run
    _, first, counts = np.unique(s_sorted, return_index=True,
                                 return_counts=True)
    mean_rank = (2 * first + counts + 1) / 2.0
    ranks = np.empty(len(scores), np.float64)
    ranks[order] = np.repeat(mean_rank, counts)
    p = labels.sum()
    n = len(labels) - p
    if p == 0 or n == 0:
        return float("nan")
    return float((ranks[labels == 1].sum() - p * (p + 1) / 2) / (p * n))
