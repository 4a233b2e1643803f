"""The sparse GAT encoder (``msha_gnn_tpu/models/gat.py``:
``SparseGATLayer``, ``SparseGAT``).

Pairwise logits ``leaky_relu(a_src . h_i + a_dst . h_j)`` over a CSR edge
list, softmax over each source row, attention-weighted aggregation of the
destination features, elu.  The parameters keep the JAX layout, ``W``
[in, out] and ``a`` [2 out, 1], so JAX weights load as they are.

``impl``:

* ``"fused"``: :class:`~msha_gnn_torch.ops.cuda.rank1_gat.Rank1GatOperator`
  (the hand-written kernels on CUDA), with attention dropout hashed inside
  the kernel from ``(seed, edge slot)``;
* ``"torch"``: the plain path, ``sddmm`` + ``edge_softmax`` + ``spmm``,
  with the same hashed keep mask, so from one generator state it computes
  what ``"fused"`` computes;
* ``"auto"``: ``"fused"`` for CUDA tensors, ``"torch"`` on the CPU.

With dropout in training, a layer draws its int32 seed from the generator
it is given, as the JAX layer draws it from ``make_rng("dropout")``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..graph import BipartiteGraph
from ..ops import edge_softmax, sddmm, spmm
from .common import dropout, elu, xavier_uniform

UNPORTED_IMPLS = {
    "xla": "the JAX package's XLA edge path is the port's impl='torch'",
    "pallas": "the materialised attention pipeline (ROADMAP queue 1 item 6: "
              "softmax, SDDMM and SpMM-dw kernels)",
    "flash": "flash-GAT (ROADMAP queue 1 item 7: _flash_kernel, "
             "_flash_bwd_kernel)",
}


def resolve_impl(impl: str, device: torch.device) -> str:
    """``"auto"`` -> ``"fused"`` on CUDA, ``"torch"`` elsewhere; raises for
    an implementation the port does not have."""
    if impl == "auto":
        return "fused" if device.type == "cuda" else "torch"
    if impl in UNPORTED_IMPLS:
        raise NotImplementedError(
            f"impl={impl!r} is not ported: {UNPORTED_IMPLS[impl]}")
    if impl not in ("torch", "fused"):
        raise ValueError(f"unknown impl {impl!r} (auto | torch | fused)")
    return impl


def draw_seed(generator: Optional[torch.Generator],
              device: torch.device) -> torch.Tensor:
    """One int32 dropout seed, drawn on ``device`` (no host sync)."""
    return torch.randint(-2**31, 2**31, (1,), generator=generator,
                         device=device, dtype=torch.int64).to(torch.int32)


class SparseGATLayer(nn.Module):
    """One GAT head over a CSR edge list (``SparseGATLayer``)."""

    def __init__(self, in_features: int, out_features: int,
                 dropout: float = 0.5, negative_slope: float = 0.2, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_features = out_features
        self.dropout = dropout
        self.negative_slope = negative_slope
        self.W = nn.Parameter(xavier_uniform((in_features, out_features),
                                             generator))
        self.a = nn.Parameter(xavier_uniform((2 * out_features, 1),
                                             generator))

    def forward(self, graph: BipartiteGraph, x: torch.Tensor, *,
                train: bool, impl: str = "auto",
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        impl = resolve_impl(impl, x.device)
        d = self.out_features
        h = x @ self.W
        av = self.a.reshape(2 * d)
        s_src = h @ av[:d]
        rate = float(self.dropout) if (train and self.dropout > 0) else 0.0
        seed = draw_seed(generator, x.device) if rate > 0 else None
        if impl == "fused":
            from ..ops.cuda.rank1_gat import Rank1GatOperator

            # cheap: the CSR/CSC build is cached per graph by operator_for
            op = Rank1GatOperator(graph, negative_slope=self.negative_slope,
                                  dst_linear=True, dropout_rate=rate)
            if seed is not None:
                return elu(op.drop(s_src, av[d:], h, seed))
            return elu(op(s_src, av[d:], h))
        logits = sddmm(graph, s_src, h @ av[d:],
                       negative_slope=self.negative_slope)
        att = edge_softmax(graph, logits)
        if seed is not None:
            from ..ops.cuda.rank1_gat import keep_scale_plain

            slots = torch.arange(graph.num_padded_edges, device=x.device)
            att = att * keep_scale_plain(slots, seed, rate)
        return elu(spmm(graph, h, edge_weight=att))


class SparseGAT(nn.Module):
    """Multi-head sparse GAT encoder: heads concat -> ``out_att`` ->
    embeddings (``SparseGAT``)."""

    def __init__(self, in_features: int, hidden: int, out_features: int,
                 n_heads: int = 2, dropout: float = 0.5, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_heads = n_heads
        self.dropout = dropout
        for i in range(n_heads):
            self.add_module(f"attention_{i}", SparseGATLayer(
                in_features, hidden, dropout, generator=generator))
        self.out_att = SparseGATLayer(hidden * n_heads, out_features,
                                      dropout, generator=generator)

    def forward(self, graph: BipartiteGraph, x: torch.Tensor, *,
                train: bool, impl: str = "auto",
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        kw = dict(train=train, impl=impl, generator=generator)
        x = dropout(x, self.dropout, train, generator)
        h = torch.cat([getattr(self, f"attention_{i}")(graph, x, **kw)
                       for i in range(self.n_heads)], dim=1)
        h = dropout(h, self.dropout, train, generator)
        return self.out_att(graph, h, **kw)
