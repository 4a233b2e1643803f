"""Training losses (``msha_gnn_tpu/training/losses.py``)."""

from __future__ import annotations

import torch


def bce_loss(scores: torch.Tensor, targets: torch.Tensor,
             eps: float = 1e-7) -> torch.Tensor:
    """Mean binary cross-entropy of probabilities, with the scores clipped
    to ``[eps, 1 - eps]`` as the JAX package clips them (not
    ``F.binary_cross_entropy``'s clamp of the log at -100)."""
    s = scores.clamp(eps, 1.0 - eps)
    return -(targets * torch.log(s)
             + (1.0 - targets) * torch.log(1.0 - s)).mean()
