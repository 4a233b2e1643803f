"""Initialisers, activations and the batch norm shared by the models
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
from torch import nn

from ..ops import dense

XAVIER_GAIN = 1.414  # the reference's gain


def xavier_uniform(shape, generator: Optional[torch.Generator],
                   gain: float = XAVIER_GAIN) -> torch.Tensor:
    """U(-b, b) with ``b = gain * sqrt(6 / (fan_in + fan_out))`` and torch's
    fan convention for a raw 2-D tensor: fan_out = rows, fan_in = columns."""
    fan_out, fan_in = shape[0], shape[1] if len(shape) > 1 else 1
    bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def xavier_uniform_stacked(shape, generator: Optional[torch.Generator],
                           gain: float = XAVIER_GAIN) -> torch.Tensor:
    """Xavier for head-stacked parameters ``[H, rows, cols]``: the bound
    takes each head's 2-D fan (fan_out = rows, fan_in = cols), so the
    heads draw as H separate :func:`xavier_uniform` draws would."""
    fan_out, fan_in = shape[-2], shape[-1]
    bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def features_with_gdp(n: int, dim: int, gdp: torch.Tensor,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    """``cat([rand(N, dim)[:, :-1], gdp[:, None]], dim=1)``: U[0, 1)
    features whose last column is the GDP scalar."""
    feats = torch.rand((n, dim), generator=generator)
    return torch.cat([feats[:, : dim - 1],
                      gdp.detach().cpu().float()[:, None]], dim=1)


def gdp_feature_init(gdp: torch.Tensor, dim: int,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
    """The learnable source features ``[N, dim]`` of the flow models."""
    return features_with_gdp(gdp.shape[0], dim, gdp, generator)


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


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """:func:`msha_gnn_torch.ops.dense.dropout` while ``training``."""
    return dense.dropout(x, rate, generator=generator,
                         deterministic=not training)


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the rows of
    a ``[rows, features]`` input, with flax's names: ``scale``, ``bias``
    and the running ``mean`` and ``var``.

    In training it normalises by the batch's mean and biased variance and
    updates ``ra = momentum * ra + (1 - momentum) * batch``, the variance
    biased too (flax keeps the old statistic with weight ``momentum``;
    ``nn.BatchNorm1d`` weights the new one, and updates with the unbiased
    variance).  Out of training it normalises by the running statistics.
    """

    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            mean = x.mean(dim=0)
            var = (x - mean).square().mean(dim=0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_(
                    mean.detach(), alpha=1.0 - self.momentum)
                self.var.mul_(self.momentum).add_(
                    var.detach(), alpha=1.0 - self.momentum)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + self.epsilon) * self.scale) \
            + self.bias
