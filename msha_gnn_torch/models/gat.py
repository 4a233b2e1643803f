"""GAT layers (``msha_gnn_tpu/models/gat.py``): the sparse encoder
``SparseGATLayer`` / ``SparseGAT``, and the reference's dense
``MaskedGATLayer``, MSHA's output layer.

Pairwise logits ``leaky_relu(a_src . h_i + a_dst . h_j)`` over a CSR edge
list, softmax over each source row, attention-weighted aggregation of the
destination features, elu.  The parameters keep the JAX layout, ``W``
[in, out] and ``a`` [2 out, 1], so JAX weights load as they are.

``impl``:

* ``"fused"``: :class:`~msha_gnn_torch.ops.cuda.rank1_gat.Rank1GatOperator`
  (the hand-written kernels on CUDA), with attention dropout hashed inside
  the kernel from ``(seed, edge slot)``;
* ``"materialised"``: the JAX package's ``impl="pallas"`` pipeline, the
  attention weights materialised per edge: the plain ``sddmm`` logits,
  ``edge_softmax(impl="cuda")`` (the row-softmax kernels; in training
  ``softmax.edge_softmax_drop``, the same kernels with the hashed keep
  mask on ``att`` folded in), ``spmm(edge_weight=att, impl="cuda")``
  (``csr_spmm_f32`` forward and ``dx``, ``csr_sddmm_f32`` for the weights'
  gradient), elu;
* ``"flash"``: the plain ``sddmm`` logits, then
  :class:`~msha_gnn_torch.ops.cuda.flash_gat.FlashGatOperator`
  (``flash_fwd_f32``: the row softmax, the hashed attention dropout and
  the aggregation in one kernel; backward ``flash_bwd_f32`` and the
  ``q``-weighted transposed ``csr_spmm_f32`` for ``dx``), elu;
* ``"torch"``: the materialised pipeline on the plain versions;
* ``"auto"``: ``"fused"`` for CUDA tensors, ``"torch"`` on the CPU.

The four compute one function: from one generator state they draw the
same keep masks, each hashed from ``(seed, CSR edge index)``.

``precision="bf16"`` streams the aggregated rows in bfloat16 with float32
arithmetic, about 2^-8 relative error: ``fused`` through
``Rank1GatOperator(precision="bf16")`` (``r1l_fwd_bf16``,
``r1l_bwd_bf16``; its logits' ``t_j = h_j . a_dst`` from the bfloat16
rows too), ``materialised`` and ``torch`` through ``spmm(precision=
"bf16")`` (``csr_spmm_bf16`` on the card).  ``flash`` ignores it, as the
JAX layer does: the flash kernels have no bfloat16 mode.  Where the
rounding falls differs between the forms, as between the JAX package's
forms, so they agree with each other to about 2^-8, not to float32.
``self_concat=True`` takes the reference's self-concat logits,
``h_i . (a_src + a_dst)`` with no destination term.  The JAX
package's materialised path draws its attention dropout from
``nn.Dropout`` (threefry), which the port does not reproduce.

With dropout in training, a layer draws its int32 seed from the generator
it is given, as the JAX layer draws it from ``make_rng("dropout")``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..graph import BipartiteGraph
from ..ops import (PRECISIONS, edge_softmax, masked_row_softmax, sddmm,
                   self_concat_logits, spmm, take_rows)
from .common import dropout, elu, gdp_feature_init, xavier_uniform

IMPLS = ("torch", "fused", "materialised", "flash")
UNPORTED_IMPLS = {
    "xla": "the JAX package's XLA edge path is the port's impl='torch'",
    "pallas": "the JAX package's materialised attention pipeline is the "
              "port's impl='materialised'",
}


def resolve_impl(impl: str, device: torch.device) -> str:
    """``"auto"`` -> ``"fused"`` on CUDA, ``"torch"`` elsewhere; raises for
    an implementation the port does not have."""
    if impl == "auto":
        return "fused" if device.type == "cuda" else "torch"
    if impl in UNPORTED_IMPLS:
        raise NotImplementedError(
            f"impl={impl!r} is not ported: {UNPORTED_IMPLS[impl]}")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (auto | {' | '.join(IMPLS)})")
    return impl


def draw_seed(generator: Optional[torch.Generator],
              device: torch.device) -> torch.Tensor:
    """One int32 dropout seed, drawn on ``device`` (no host sync)."""
    return torch.randint(-2**31, 2**31, (1,), generator=generator,
                         device=device, dtype=torch.int64).to(torch.int32)


class MaskedGATLayer(nn.Module):
    """The reference's ``GraphAttentionLayer`` (``MaskedGATLayer``).

    ``h = x @ W``; the per-row logit ``leaky_relu([h_i || h_i] . a)``;
    masked with -9e15 where ``adj_mask`` is False; row softmax; dropout;
    ``elu(att * h)``.  The self-concat makes the attention uniform over
    each row's unmasked entries, and the elementwise "aggregation" needs
    ``out_features`` equal to the mask's columns: the reference's
    behaviour, kept.
    """

    def __init__(self, in_features: int, out_features: int,
                 dropout: float = 0.5, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        self.W = nn.Parameter(xavier_uniform((in_features, out_features),
                                             generator))
        self.a = nn.Parameter(xavier_uniform((2 * out_features, 1),
                                             generator))

    def forward(self, x: torch.Tensor, adj_mask: torch.Tensor, *,
                train: bool,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = x @ self.W
        row_logit = self_concat_logits(h, self.a)
        att = masked_row_softmax(row_logit[:, None].expand_as(h), adj_mask)
        att = dropout(att, self.dropout, train, generator)
        return elu(att * h)


class GAT(nn.Module):
    """The reference's two-stage multi-head GAT (``GAT``): ``n_heads``
    :class:`MaskedGATLayer` heads ``attention_{i}`` concatenated, then the
    output layer ``out_att`` over the concat (input width ``n_classes *
    n_heads``), elu, log-softmax.  With ``gdp`` the node features are the
    learnable ``features`` [N, n_features] with the GDP scalar in the last
    column; an explicit ``x`` replaces them."""

    def __init__(self, n_features: int, n_classes: int, n_heads: int = 2,
                 dropout: float = 0.5, *, gdp: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_heads, self.dropout = n_heads, dropout
        if gdp is not None:
            self.features = nn.Parameter(
                gdp_feature_init(gdp, n_features, generator))
        for i in range(n_heads):
            self.add_module(f"attention_{i}", MaskedGATLayer(
                n_features, n_classes, dropout, generator=generator))
        self.out_att = MaskedGATLayer(n_classes * n_heads, n_classes,
                                      dropout, generator=generator)

    def forward(self, adj_mask: torch.Tensor,
                x: Optional[torch.Tensor] = None, *, train: bool,
                rows: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Log-probabilities ``[R, n_classes]`` of ``rows`` (all N when
        None).  The model is row-local (self-concat logits, elementwise
        aggregation), so ``rows`` cuts the features and the mask first."""
        if x is None:
            x = self.features
        if rows is not None:
            x = take_rows(x, rows)
            adj_mask = adj_mask[rows.long()]
        kw = dict(train=train, generator=generator)
        x = dropout(x, self.dropout, train, generator)
        x = torch.cat([getattr(self, f"attention_{i}")(x, adj_mask, **kw)
                       for i in range(self.n_heads)], dim=1)
        x = dropout(x, self.dropout, train, generator)
        x = elu(self.out_att(x, adj_mask, **kw))
        return F.log_softmax(x, dim=1)


class SparseGATLayer(nn.Module):
    """One GAT head over a CSR edge list (``SparseGATLayer``).

    ``self_concat``: the logit is ``leaky_relu(h_i . (a_src + a_dst))``,
    the reference's self-concat form, instead of ``h_i . a_src + h_j .
    a_dst``.  ``precision``: ``"f32"`` or ``"bf16"`` (the module's
    docstring)."""

    def __init__(self, in_features: int, out_features: int,
                 dropout: float = 0.5, negative_slope: float = 0.2, *,
                 self_concat: bool = False, precision: str = "f32",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r} (f32 | bf16)")
        self.out_features = out_features
        self.dropout = dropout
        self.negative_slope = negative_slope
        self.self_concat = self_concat
        self.precision = precision
        self.W = nn.Parameter(xavier_uniform((in_features, out_features),
                                             generator))
        self.a = nn.Parameter(xavier_uniform((2 * out_features, 1),
                                             generator))

    def forward(self, graph: BipartiteGraph, x_src: torch.Tensor,
                x_dst: Optional[torch.Tensor] = None, *, train: bool,
                impl: str = "auto",
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``x_src`` [n_src, in] gives the rows' logit term, ``x_dst``
        [n_dst, in] (default ``x_src``, for a square graph) the columns'
        logit term and the features aggregated, as the JAX layer's
        ``(graph, x_src, x_dst)``."""
        impl = resolve_impl(impl, x_src.device)
        d = self.out_features
        h_src = x_src @ self.W
        # one GEMM when the two sides are the same tensor (eager PyTorch
        # does not merge the duplicate)
        h_dst = h_src if x_dst is None or x_dst is x_src else x_dst @ self.W
        av = self.a.reshape(2 * d)
        if self.self_concat:
            s_src = h_src @ (av[:d] + av[d:])
            a_dst = av.new_zeros(d)
        else:
            s_src = h_src @ av[:d]
            a_dst = av[d:]
        rate = float(self.dropout) if (train and self.dropout > 0) else 0.0
        seed = draw_seed(generator, x_src.device) if rate > 0 else None
        if impl == "fused":
            from ..ops.cuda.rank1_gat import Rank1GatOperator

            # cheap: the CSR/CSC build is cached per graph by operator_for
            op = Rank1GatOperator(graph, negative_slope=self.negative_slope,
                                  precision=self.precision, dst_linear=True,
                                  dropout_rate=rate)
            if seed is not None:
                return elu(op.drop(s_src, a_dst, h_dst, seed))
            return elu(op(s_src, a_dst, h_dst))
        s_dst = (h_dst.new_zeros(graph.n_dst) if self.self_concat
                 else h_dst @ a_dst)
        logits = sddmm(graph, s_src, s_dst,
                       negative_slope=self.negative_slope)
        if impl == "flash":
            from ..ops.cuda.flash_gat import FlashGatOperator

            op = FlashGatOperator(graph, dropout_rate=rate)
            if seed is not None:
                return elu(op.drop(logits, h_dst, seed))
            return elu(op(logits, h_dst))
        ops_impl = "cuda" if impl == "materialised" else "torch"
        if seed is None:
            att = edge_softmax(graph, logits, impl=ops_impl)
        elif impl == "materialised":
            from ..ops.cuda import softmax as cuda_softmax

            att = cuda_softmax.edge_softmax_drop(graph, logits, seed, rate)
        else:
            from ..ops.cuda.rank1_gat import keep_scale_plain

            att = edge_softmax(graph, logits) * keep_scale_plain(
                torch.arange(graph.num_padded_edges, device=x_src.device),
                seed, rate)
        return elu(spmm(graph, h_dst, edge_weight=att, impl=ops_impl,
                        precision=self.precision))


class SparseGAT(nn.Module):
    """Multi-head sparse GAT encoder: heads concat -> ``out_att`` ->
    embeddings (``SparseGAT``); ``precision`` reaches every layer."""

    def __init__(self, in_features: int, hidden: int, out_features: int,
                 n_heads: int = 2, dropout: float = 0.5, *,
                 precision: str = "f32",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_heads = n_heads
        self.dropout = dropout
        for i in range(n_heads):
            self.add_module(f"attention_{i}", SparseGATLayer(
                in_features, hidden, dropout, precision=precision,
                generator=generator))
        self.out_att = SparseGATLayer(hidden * n_heads, out_features,
                                      dropout, precision=precision,
                                      generator=generator)

    def forward(self, graph: BipartiteGraph, x: torch.Tensor, *,
                train: bool, impl: str = "auto",
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        kw = dict(train=train, impl=impl, generator=generator)
        x = dropout(x, self.dropout, train, generator)
        h = torch.cat([getattr(self, f"attention_{i}")(graph, x, x, **kw)
                       for i in range(self.n_heads)], dim=1)
        h = dropout(h, self.dropout, train, generator)
        return self.out_att(graph, h, h, **kw)
