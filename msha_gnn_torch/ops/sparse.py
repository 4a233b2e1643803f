"""Sparse products over :class:`~msha_gnn_torch.graph.BipartiteGraph`
(``msha_gnn_tpu/ops/sparse.py``).

``impl="torch"`` is the plain version, gather + ``index_add_``: the CPU
path and the oracle of the CUDA kernel.  ``impl="cuda"`` goes to the
hand-written CSR kernel through :mod:`msha_gnn_torch.ops.cuda.spmm`.
:func:`sddmm` and :func:`edge_softmax` are plain only: they make the
plain GAT path (``SparseGATLayer(impl="torch")``).
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


def spmm(
    graph: "BipartiteGraph",
    x: torch.Tensor,
    *,
    edge_weight: Optional[torch.Tensor] = None,
    transpose: bool = False,
    impl: str = "torch",
) -> torch.Tensor:
    """``A @ x`` (or ``A.T @ x``) with A the [n_src, n_dst] weight matrix.

    x: [n_dst, d] (or [n_src, d] when transposed).  Returns [n_src, d]
    (or [n_dst, d]).  ``edge_weight`` ([E_pad], CSR edge order) overrides
    the stored weights.
    """
    if impl == "cuda":
        from .cuda.spmm import spmm_cuda

        return spmm_cuda(graph, x, edge_weight=edge_weight,
                         transpose=transpose)
    if impl != "torch":
        raise ValueError(f"unknown spmm impl {impl!r} (torch | cuda)")
    w = graph.weight if edge_weight is None else edge_weight
    if transpose:
        gathered = _gather_rows(x, graph.senders, graph.n_src)
        return segment_sum(gathered * w[:, None], graph.receivers, graph.n_dst)
    gathered = _gather_rows(x, graph.receivers, graph.n_dst)
    return segment_sum(gathered * w[:, None], graph.senders, graph.n_src)


def sddmm(graph: "BipartiteGraph", src_vec: torch.Tensor,
          dst_vec: torch.Tensor, *, negative_slope: float = 0.2
          ) -> torch.Tensor:
    """Per-edge GAT logits ``leaky_relu(src_vec[s] + dst_vec[r])`` -> [E_pad]
    (padding entries are garbage; mask downstream)."""
    e = (_gather_rows(src_vec[:, None], graph.senders, graph.n_src)[:, 0]
         + _gather_rows(dst_vec[:, None], graph.receivers, graph.n_dst)[:, 0])
    return torch.nn.functional.leaky_relu(e, negative_slope)


def edge_softmax(graph: "BipartiteGraph", logits: torch.Tensor, *,
                 per: str = "src") -> torch.Tensor:
    """Softmax of per-edge logits over each source row (``per="src"``) or
    destination column (``per="dst"``); padding edges get 0."""
    if per == "src":
        return segment_softmax(logits, graph.senders, graph.n_src,
                               mask=graph.edge_mask)
    return segment_softmax(logits, graph.receivers, graph.n_dst,
                           mask=graph.edge_mask)
