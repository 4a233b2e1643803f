"""Link-prediction metrics: ``hits_at_k``
(``msha_gnn_tpu/training/metrics.py``) and the binary AUC
(``msha_gnn_tpu/training/kd.py::_binary_auc_np``)."""

from __future__ import annotations

import numpy as np
import torch


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
