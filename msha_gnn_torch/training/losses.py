"""Training losses (``msha_gnn_tpu/training/losses.py``): the NLL and
BCE of the trainers, and the LLP knowledge-distillation terms."""

from __future__ import annotations

from typing import Optional

import torch


def nll_loss(log_probs: torch.Tensor, labels: torch.Tensor,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean negative log-likelihood of the integer ``labels`` [B] under
    ``log_probs`` [B, M].  With ``weights`` [B] it is the training step's
    weighted form ``sum(per * w) / max(sum(w), 1)``
    (``msha_gnn_tpu/training/trainer.py:75-99``), so the rows a padded
    batch carries with weight 0 add nothing."""
    per = -log_probs.gather(1, labels.long()[:, None])[:, 0]
    if weights is None:
        return per.mean()
    return (per * weights).sum() / weights.sum().clamp_min(1.0)


def bce_loss(scores: torch.Tensor, targets: torch.Tensor,
             eps: float = 1e-7) -> torch.Tensor:
    """Mean binary cross-entropy of probabilities, with the scores clipped
    to ``[eps, 1 - eps]`` as the JAX package clips them (not
    ``F.binary_cross_entropy``'s clamp of the log at -100)."""
    s = scores.clamp(eps, 1.0 - eps)
    return -(targets * torch.log(s)
             + (1.0 - targets) * torch.log(1.0 - s)).mean()


def kd_cosine(student: torch.Tensor, teacher: torch.Tensor,
              eps: float = 1e-8) -> torch.Tensor:
    """``1 - mean(cosine_similarity(s, t))`` over the rows, the teacher
    detached.  The eps sits inside the sqrt of the norms' product: at an
    exactly zero row (dropout and relu make them) ``d|h|/dh`` is 0/0
    otherwise, and one NaN row poisons every parameter after a step."""
    teacher = teacher.detach()
    num = (student * teacher).sum(-1)
    den = torch.sqrt(((student * student).sum(-1) + eps)
                     * ((teacher * teacher).sum(-1) + eps))
    return 1.0 - (num / den).mean()


def mse_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).mean()


def kd_loss(label_loss: torch.Tensor, student_h: torch.Tensor,
            teacher_h: torch.Tensor, student_scores: torch.Tensor,
            teacher_scores: torch.Tensor, *, true_label_weight: float = 10.0,
            kd_f: float = 0.1, kd_p: float = 100.0):
    """The LLP objective ``true_label_weight * label + kd_f * cosine + kd_p
    * mse``, the teacher's embedding and scores detached.  Returns
    ``(total, {"label", "kd_cosine", "kd_mse"})``."""
    cos = kd_cosine(student_h, teacher_h)
    mse = mse_loss(student_scores, teacher_scores.detach())
    total = true_label_weight * label_loss + kd_f * cos + kd_p * mse
    return total, {"label": label_loss, "kd_cosine": cos, "kd_mse": mse}


def margin_rank_loss(pos_scores: torch.Tensor, neg_scores: torch.Tensor,
                     margin: float = 0.1) -> torch.Tensor:
    """Pairwise margin ranking over matched positive / negative scores."""
    return torch.relu(margin - pos_scores + neg_scores).mean()
