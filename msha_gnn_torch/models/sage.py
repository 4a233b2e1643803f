"""The GraphSAGE-style baseline (``msha_gnn_tpu/models/sage.py``).

Two linear layers with an adjacency-row gate between them: ``x =
relu(linear1(S[batch]))``, ``x = adj_rows * x`` (elementwise, so
``hidden_features`` equals the number of recipients M), ``relu(linear2(
x))``, log-softmax.  The gate's rows are the batch's rows of the
column-normalised inter adjacency.  Plain PyTorch, as the JAX model is XLA
code; the two layers keep flax's ``Dense`` initialisation.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..graph import BipartiteGraph
from .common import gdp_feature_init
from .mlp import dense


def gather_dense_rows(graph: BipartiteGraph, rows: torch.Tensor,
                      max_degree: int) -> torch.Tensor:
    """Rows ``rows`` of the bipartite weight matrix, dense -> [B, n_dst].

    O(B max_degree): each row's CSR edge span (at most ``max_degree``
    edges) is gathered and added into its n_dst columns; duplicate
    columns add up, as the JAX function's scatter-add does."""
    rows = rows.long()
    ptr = graph.row_ptr.long()
    starts = ptr[rows]
    ends = ptr[torch.clamp(rows + 1, max=graph.n_src)]
    idx = starts[:, None] + torch.arange(max_degree, device=ptr.device)
    valid = idx < ends[:, None]
    idx = idx.clamp(max=graph.num_padded_edges - 1)
    recv = torch.where(valid, graph.receivers[idx].long(), graph.n_dst)
    w = torch.where(valid, graph.weight[idx], 0.0)
    out = w.new_zeros((rows.shape[0], graph.n_dst + 1))
    out.scatter_add_(1, recv, w)
    return out[:, : graph.n_dst]


class GraphSAGE(nn.Module):
    """``GraphSAGE``: learnable source features ``Sfeatures`` [N, in] with
    the GDP scalar in the last column, ``linear1`` [in -> hidden] and
    ``linear2`` [hidden -> out]; ``hidden_features`` must equal n_dst."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, *, gdp: torch.Tensor,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Sfeatures = nn.Parameter(
            gdp_feature_init(gdp, in_features, generator))
        self.linear1 = dense(in_features, hidden_features, generator)
        self.linear2 = dense(hidden_features, out_features, generator)

    def forward(self, batch: torch.Tensor, adj_rows: torch.Tensor, *,
                train: bool = False) -> torch.Tensor:
        """Log-probabilities [B, out] of the rows ``batch``; ``adj_rows``
        [B, M] their dense rows of the normalised inter adjacency.  The
        model has no dropout: ``train`` is taken for the JAX signature."""
        x = torch.relu(self.linear1(self.Sfeatures[batch.long()]))
        x = adj_rows * x
        x = torch.relu(self.linear2(x))
        return F.log_softmax(x, dim=1)
