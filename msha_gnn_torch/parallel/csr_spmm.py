"""The CSR SpMM kernels on an edge partition: each rank runs the port's
``csr_spmm_f32`` and ``csr_sddmm_f32`` on its own CSR row block
(``msha_gnn_tpu/parallel/pallas_spmm.py::ShardedPallasSpmm``).

Placement as :class:`~.dist_spmm.DistributedSpmm` (blocks of rows,
:mod:`.comm`); the per-shard reduce is the hand-written kernel:

* forward: all-gather the destination blocks, one ``csr_spmm_f32`` over
  the shard's CSR (its senders local, its receivers global); the output
  rows stay this rank's block, with no reduction collective;
* ``dx``: one transposed ``csr_spmm_f32`` of the cotangent block over the
  shard's CSC into a partial ``[k dst_blk, d]``, then a reduce-scatter;
* ``dw`` (runtime weights): one ``csr_sddmm_f32`` in shard-CSR order, the
  shards' prefixes being the parent's CSR order.

Each shard is a :class:`~msha_gnn_torch.ops.cuda.spmm.SpmmOperator` of its
row block, so at ``k = 1`` the launches are the single-device operator's,
on the same arrays.  The JAX operator's ``hub_split`` (a table of the
hottest receivers kept in TPU VMEM) is a TPU schedule and is left out, as
is ``interpret``: the kernel's edge-run walk needs no hub table.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..graph import BipartiteGraph
from ..ops.cuda.sddmm import csr_sddmm
from ..ops.cuda.spmm import SpmmOperator
from .comm import all_gather, copy_to_local, reduce_scatter
from .dist_spmm import _check_rows
from .mesh import Mesh
from .partition import shard_graph, shard_rows


class _ShardedSpmmFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, op):
        ctx.op = op
        ctx.save_for_backward(x, w)
        return op.local.apply(all_gather(x, op.mesh), w, False)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        op, g = ctx.op, g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = reduce_scatter(op.local.apply(g, w, True), op.mesh)
        if w is not None and ctx.needs_input_grad[1]:
            loc = op.local
            dw = csr_sddmm(loc.ptr, loc.col, g, all_gather(x, op.mesh),
                           w.shape[0])
        return dx, dw, None


class ShardedCsrSpmm:
    """Differentiable ``A @ x`` over the mesh's ranks with the
    per-shard CSR kernels; ``x`` is this rank's [dst_blk, d] block, the
    output its [row_blk, d] block."""

    def __init__(self, graph: BipartiteGraph, mesh: Mesh):
        self.graph, self.mesh, self.k = graph, mesh, mesh.world
        sh = shard_rows(graph, self.k, mesh.rank)
        self.row_blk = sh.row_blk
        self.dst_blk = -(-graph.n_dst // self.k)
        self._lo, self._hi = sh.lo, sh.hi
        self.local = SpmmOperator(shard_graph(sh, self.k * self.dst_blk),
                                  mesh.device)

    def partition_weights(self, w_csr: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the CSR-order per-edge scalars
        (differentiable: the gradient is the whole ``dw``)."""
        return copy_to_local(w_csr, self.mesh)[self._lo:self._hi] \
            .float().contiguous()

    def __call__(self, x: torch.Tensor, *,
                 edge_weight: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        _check_rows(x, self.dst_blk, self.mesh.device, "x")
        w = (None if edge_weight is None
             else self.partition_weights(edge_weight))
        return _ShardedSpmmFn.apply(x.contiguous(), w, self)
