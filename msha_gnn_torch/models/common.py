"""Initialisers and activations shared by the models
(``msha_gnn_tpu/models/common.py``, plus flax's ``Dense`` defaults).

Every initialiser draws from an explicit :class:`torch.Generator`, and so
does :func:`dropout`: two runs from the same generator state draw the same
values and masks.  The values differ from the JAX package's, whose PRNG is
another; the distributions are the same.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

XAVIER_GAIN = 1.414  # the reference's gain


def xavier_uniform(shape, generator: Optional[torch.Generator],
                   gain: float = XAVIER_GAIN) -> torch.Tensor:
    """U(-b, b) with ``b = gain * sqrt(6 / (fan_in + fan_out))`` and torch's
    fan convention for a raw 2-D tensor: fan_out = rows, fan_in = columns."""
    fan_out, fan_in = shape[0], shape[1] if len(shape) > 1 else 1
    bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def lecun_normal(shape, fan_in: int,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's default ``Dense`` kernel init: a normal truncated at two
    standard deviations, scaled to variance ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, std,
                                       -2 * std, 2 * std,
                                       generator=generator)


def elu(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with its mask drawn from ``generator`` (on ``x``'s
    device); the identity when not training or at rate 0, as flax's
    ``nn.Dropout``."""
    if not training or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)
