"""Sparse products over :class:`~msha_gnn_torch.graph.BipartiteGraph`
(``msha_gnn_tpu/ops/sparse.py``).

``impl="torch"`` is the plain version, gather + ``index_add_``: the CPU
path and the oracle of the CUDA kernels.  ``impl="cuda"`` goes to the
hand-written kernels (the JAX package's ``impl="pallas"``): :func:`spmm`
through :mod:`.cuda.spmm`, :func:`sddmm` and :func:`sddmm_dot` through
:mod:`.cuda.sddmm` and :func:`edge_softmax` through :mod:`.cuda.softmax`.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import torch

from .segment import segment_softmax, segment_sum

if TYPE_CHECKING:
    from ..graph import BipartiteGraph


def _gather_rows(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Rows of ``x`` at ``idx``, zeros for the padding id ``n``."""
    x_pad = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    return x_pad[idx.long().clamp(0, n)]


class _Bf16Rows(torch.autograd.Function):
    """``x`` rounded to bfloat16 and widened back; the cotangent passes
    through as it is (float32)."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


class _Bf16Cotangent(torch.autograd.Function):
    """The identity, whose cotangent is rounded to bfloat16 (and widened
    back) on its way to the rows it is streamed to."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


PRECISIONS = ("f32", "bf16")


def spmm(
    graph: "BipartiteGraph",
    x: torch.Tensor,
    *,
    edge_weight: Optional[torch.Tensor] = None,
    transpose: bool = False,
    impl: str = "torch",
    precision: str = "f32",
) -> torch.Tensor:
    """``A @ x`` (or ``A.T @ x``) with A the [n_src, n_dst] weight matrix.

    x: [n_dst, d] (or [n_src, d] when transposed).  Returns [n_src, d]
    (or [n_dst, d]).  ``edge_weight`` ([E_pad], CSR edge order) overrides
    the stored weights.

    ``precision="bf16"``: the rows are streamed in bfloat16 and every
    product and sum is taken in float32, about 2^-8 relative error: ``x``
    is rounded to bfloat16 before the gather, and in the backward the
    cotangent is rounded before the transposed gather of ``dx``.  So
    ``dx = A.T (w * bf16(g))`` and ``dw_e = <bf16(g)[row_e],
    bf16(x)[col_e]>``, in float32; the cotangent reaching ``x`` through
    the rounding is float32.  ``impl="cuda"`` computes the same function
    with the bfloat16 kernels (:class:`~.cuda.spmm.SpmmOperator`).
    """
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r} (f32 | bf16)")
    if impl == "cuda":
        from .cuda.spmm import spmm_cuda

        return spmm_cuda(graph, x, edge_weight=edge_weight,
                         transpose=transpose, precision=precision)
    if impl != "torch":
        raise ValueError(f"unknown spmm impl {impl!r} (torch | cuda)")
    if precision == "bf16":
        out = spmm(graph, _Bf16Rows.apply(x), edge_weight=edge_weight,
                   transpose=transpose)
        return _Bf16Cotangent.apply(out)
    w = graph.weight if edge_weight is None else edge_weight
    if transpose:
        gathered = _gather_rows(x, graph.senders, graph.n_src)
        return segment_sum(gathered * w[:, None], graph.receivers, graph.n_dst)
    gathered = _gather_rows(x, graph.receivers, graph.n_dst)
    return segment_sum(gathered * w[:, None], graph.senders, graph.n_src)


def sddmm(graph: "BipartiteGraph", src_vec: torch.Tensor,
          dst_vec: torch.Tensor, *, negative_slope: float = 0.2,
          impl: str = "torch") -> torch.Tensor:
    """Per-edge GAT logits ``leaky_relu(src_vec[s] + dst_vec[r])`` -> [E_pad]
    (padding entries are garbage; mask downstream).  ``impl="cuda"``: one
    ``csr_sddmm_f32`` launch on the width-2 columns ``[src_vec, 1]``,
    ``[1, dst_vec]`` (pads 0), its adjoints two weighted SpMMs
    (:func:`~.cuda.sddmm.sddmm_cuda`)."""
    if impl == "cuda":
        from .cuda.sddmm import sddmm_cuda

        return sddmm_cuda(graph, src_vec, dst_vec,
                          negative_slope=negative_slope)
    if impl != "torch":
        raise ValueError(f"unknown sddmm impl {impl!r} (torch | cuda)")
    e = (_gather_rows(src_vec[:, None], graph.senders, graph.n_src)[:, 0]
         + _gather_rows(dst_vec[:, None], graph.receivers, graph.n_dst)[:, 0])
    return torch.nn.functional.leaky_relu(e, negative_slope)


def sddmm_dot(graph: "BipartiteGraph", src_feat: torch.Tensor,
              dst_feat: torch.Tensor, *, impl: str = "torch") -> torch.Tensor:
    """Per-edge inner products ``<src_feat[s], dst_feat[r]>`` -> [E_pad]
    (padding entries 0)."""
    if impl == "cuda":
        from .cuda.sddmm import sddmm_dot_cuda

        return sddmm_dot_cuda(graph, src_feat, dst_feat)
    if impl != "torch":
        raise ValueError(f"unknown sddmm_dot impl {impl!r} (torch | cuda)")
    s = _gather_rows(src_feat, graph.senders, graph.n_src)
    d = _gather_rows(dst_feat, graph.receivers, graph.n_dst)
    return (s * d).sum(-1)


def edge_softmax(graph: "BipartiteGraph", logits: torch.Tensor, *,
                 per: str = "src", impl: str = "torch") -> torch.Tensor:
    """Softmax of per-edge logits over each source row (``per="src"``) or
    destination column (``per="dst"``); padding edges get 0.
    ``impl="cuda"`` runs the row-softmax kernels for ``per="src"``; the
    column softmax takes the plain path, as the JAX package's
    ``impl="pallas"`` takes its XLA path there."""
    if impl not in ("torch", "cuda"):
        raise ValueError(f"unknown edge_softmax impl {impl!r} (torch | cuda)")
    if impl == "cuda" and per == "src":
        from .cuda.softmax import edge_softmax_cuda

        return edge_softmax_cuda(graph, logits)
    if per == "src":
        return segment_softmax(logits, graph.senders, graph.n_src,
                               mask=graph.edge_mask)
    return segment_softmax(logits, graph.receivers, graph.n_dst,
                           mask=graph.edge_mask)
