"""The MLP student and the link predictor (``msha_gnn_tpu/models/mlp.py``).

Linear layers are ``nn.Linear`` (weight [out, in]) with flax's ``Dense``
initialisation: a truncated LeCun normal kernel and a zero bias.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .common import WHOLE, Shard, dropout, lecun_normal


def dense(in_features: int, out_features: int,
          generator: Optional[torch.Generator]) -> nn.Linear:
    """``nn.Linear`` initialised as flax's ``nn.Dense``."""
    lin = nn.Linear(in_features, out_features)
    with torch.no_grad():
        lin.weight.copy_(lecun_normal((out_features, in_features),
                                      in_features, generator))
        lin.bias.zero_()
    return lin


class MLP(nn.Module):
    """Configurable-depth MLP (``MLP``, ``norm_type="none"``): relu and
    dropout after every layer but the last."""

    def __init__(self, num_layers: int, input_dim: int, hidden_dim: int,
                 output_dim: int, dropout_ratio: float = 0.5, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            dense(dims[i], dims[i + 1], generator) for i in range(num_layers))
        self.dropout_ratio = dropout_ratio

    def forward(self, x: torch.Tensor, *, train: bool,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = dropout(torch.relu(x), self.dropout_ratio, train,
                            generator)
        return x


class LinkPredictor(nn.Module):
    """Edge scorer on embedding pairs (``LinkPredictor``): the Hadamard
    product ``x_i * x_j``, then an MLP tower (``"mlp"``) or a sum
    (``"inner"``), then sigmoid.  ``final_linear=False`` keeps the
    reference's shipped behaviour (no last linear, a [B, hidden] output)."""

    def __init__(self, predictor: str, hidden_channels: int,
                 num_layers: int = 2, dropout: float = 0.5,
                 final_linear: bool = True, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if predictor not in ("mlp", "inner"):
            raise ValueError(f"unknown predictor {predictor!r}")
        self.predictor = predictor
        self.dropout = dropout
        self.final_linear = final_linear
        lins = []
        if predictor == "mlp":
            lins = [dense(hidden_channels, hidden_channels, generator)
                    for _ in range(num_layers - 1)]
            if final_linear:
                lins.append(dense(hidden_channels, 1, generator))
        self.lins = nn.ModuleList(lins)

    def forward(self, x_i: torch.Tensor, x_j: torch.Tensor, *, train: bool,
                generator: Optional[torch.Generator] = None,
                shard: Shard = WHOLE) -> torch.Tensor:
        """Scores of the pairs ``(x_i, x_j)``: ``shard``'s rows of the
        batch (:class:`~msha_gnn_torch.models.common.Shard`), each dropout
        mask that of the whole batch."""
        x = x_i * x_j
        if self.predictor == "inner":
            return torch.sigmoid(x.sum(-1))

        def linear(lin, x):
            return F.linear(x, shard.local(lin.weight), shard.local(lin.bias))

        n_hidden = len(self.lins) - int(self.final_linear)
        for lin in self.lins[:n_hidden]:
            x = shard.dropout(torch.relu(linear(lin, x)), self.dropout, train,
                              generator)
        if self.final_linear:
            x = linear(self.lins[n_hidden], x)[..., 0]
        return torch.sigmoid(x)
