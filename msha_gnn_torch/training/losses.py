"""Training losses (``msha_gnn_tpu/training/losses.py``)."""

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
