"""Optimisers (``msha_gnn_tpu/training/optim.py``)."""

from __future__ import annotations

import torch


def adam_l2(params, lr: float, weight_decay: float = 0.0
            ) -> torch.optim.Adam:
    """Adam with coupled L2 (``weight_decay`` added to the gradient before
    the moments), the JAX package's ``add_decayed_weights`` + ``adam``."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
