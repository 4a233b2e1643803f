"""Optimisers (``msha_gnn_tpu/training/optim.py``).

Each takes the parameters to optimise, in torch's idiom, where the JAX
functions return an optax transformation.  The weight decay is coupled L2
(``weight_decay * param`` added to the gradient before the moments or the
momentum), as the JAX chains put ``add_decayed_weights`` first.
"""

from __future__ import annotations

import torch


def adam_l2(params, lr: float, weight_decay: float = 0.0
            ) -> torch.optim.Adam:
    """Adam with coupled L2, the JAX package's ``add_decayed_weights`` +
    ``adam``."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def sgd_momentum(params, lr: float, momentum: float = 0.9,
                 weight_decay: float = 0.0) -> torch.optim.SGD:
    """SGD with heavy-ball momentum (the trace starts at the first
    gradient, no dampening) after coupled L2, optax's
    ``add_decayed_weights`` + ``sgd(momentum=)``."""
    return torch.optim.SGD(params, lr=lr, momentum=momentum,
                           weight_decay=weight_decay)
