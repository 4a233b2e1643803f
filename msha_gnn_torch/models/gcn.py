"""GCN over the bipartite flow graph (``msha_gnn_tpu/models/gcn.py``).

``GraphConvolution`` computes ``support = x @ W`` and propagates it with a
CSR SpMM; no dense adjacency is formed.  Weights keep the JAX package's
``[in, out]`` layout and its U(-stdv, stdv) initialisation, with a
per-feature bias; the features are U[0, 1) with the GDP column appended.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..graph import BipartiteGraph
from ..ops import dense, spmm


def _uniform(shape, stdv: float, generator: Optional[torch.Generator]):
    return torch.empty(shape).uniform_(-stdv, stdv, generator=generator)


class GraphConvolution(nn.Module):
    """``out = A^T @ (x @ W) + b`` (``to_src=False``, src -> dst) or
    ``A @ (x @ W) + b`` (``to_src=True``, dst -> src)."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        stdv = 1.0 / math.sqrt(out_features)
        self.weight = nn.Parameter(
            _uniform((in_features, out_features), stdv, generator))
        self.bias = (nn.Parameter(_uniform((out_features,), stdv, generator))
                     if use_bias else None)

    def forward(self, x: torch.Tensor, graph: BipartiteGraph, *,
                to_src: bool = False, impl: str = "torch") -> torch.Tensor:
        support = x @ self.weight
        out = spmm(graph, support, transpose=not to_src, impl=impl)
        if self.bias is not None:
            out = out + self.bias
        return out


class GCN(nn.Module):
    """2-layer bipartite round-trip GCN: N -> M -> N.

    ``features`` is a learnable [N, nfeat + 1] matrix whose last column is
    the GDP scalar.  ``nclass`` is kept for the JAX signature; both layers
    are ``nhid`` wide, as there.
    """

    def __init__(self, nfeat: int, nhid: int, nclass: int,
                 dropout: float = 0.5, *, gdp: torch.Tensor,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        n = gdp.shape[0]
        feats = torch.rand((n, nfeat), generator=generator)
        self.features = nn.Parameter(
            torch.cat([feats, gdp.detach().cpu().float()[:, None]], dim=1))
        self.gc1 = GraphConvolution(nfeat + 1, nhid, generator=generator)
        self.gc2 = GraphConvolution(nhid, nhid, generator=generator)

    def forward(self, graph: BipartiteGraph, *, train: bool = False,
                impl: str = "torch",
                rows: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Log-probabilities ``[R, nhid]`` of ``rows`` (all N when None);
        in training the dropout mask is drawn from ``generator``."""
        x = F.relu(self.gc1(self.features, graph, impl=impl))  # [M, nhid]
        x = dense.dropout(x, self.dropout, generator=generator,
                          deterministic=not train)
        x = F.relu(self.gc2(x, graph, to_src=True, impl=impl))  # [N, nhid]
        if rows is not None:
            x = x[rows.long()]
        return F.log_softmax(x, dim=1)
