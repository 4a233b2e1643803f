"""The fused rank-1 GAT on an edge partition
(``msha_gnn_tpu/parallel/rank1_dist.py::ShardedRank1Gat``).

Edges are partitioned by source row (:mod:`.partition`), and the segment
softmax normalises over a source row's edges, all of which live on the
row's owner: each rank's ``r1l_fwd_f32`` computes exact softmax rows with
no cross-rank normalisation.

* forward: all-gather the destination blocks of ``x``, one
  ``r1l_fwd_f32`` over the shard's CSR (the kernel gathers ``x``'s rows by
  the receivers' indices; no ``[E, d]`` array of ordered rows is built, as
  the JAX operator's ``x_ord`` is, which at 50 M edges and ``d`` 128 would
  take 25.6 GB); the output rows stay this rank's block;
* backward: one ``r1l_bwd_f32`` (``q``, ``dpre``, ``dc`` of the local
  rows, a partial ``da``); ``da`` is all-reduced; ``dx``'s partial is the
  ``q``-weighted transposed ``csr_spmm_f32`` of the cotangent plus ``a``
  times the d = 1 column sums of ``dpre``
  (:func:`~msha_gnn_torch.ops.cuda.rank1_gat.assemble_dx`), then a
  reduce-scatter.

Same math as ``Rank1GatOperator(dst_linear=True)``: ``att =
segment_softmax(leaky_relu(c[snd] + (x @ a)[rcv]))`` per source row,
``out[i] = sum_e att_e x[rcv_e]``.  At ``k = 1`` the launches are that
operator's, on the same arrays.
"""

from __future__ import annotations

import torch

from ..graph import BipartiteGraph
from ..ops.cuda.rank1_gat import assemble_dx, r1l_bwd, r1l_fwd
from ..ops.cuda.spmm import SpmmOperator
from .comm import all_gather, all_reduce, reduce_scatter
from .dist_spmm import _check_rows
from .mesh import Mesh
from .partition import shard_graph, shard_rows


class _ShardedRank1Fn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, c, a, x, op):
        sp, seed = op.local, op.seed
        x_full = all_gather(x, op.mesh)
        out, lse = r1l_fwd(sp.ptr, sp.col, c, a, x_full, seed, 0.0,
                           op.slope, op.row_blk)
        ctx.save_for_backward(c, a, x_full, out, lse)
        ctx.op = op
        return out

    @staticmethod
    def backward(ctx, gout):
        c, a, x_full, out, lse = ctx.saved_tensors
        op, gout = ctx.op, gout.contiguous()
        sp = op.local
        q, dpre, dc, da = r1l_bwd(sp.ptr, sp.col, c, a, x_full, gout, out,
                                  lse, op.seed, 0.0, op.slope, op.row_blk)
        da = all_reduce(da, op.mesh)
        dx = None
        if ctx.needs_input_grad[2]:
            dx = reduce_scatter(assemble_dx(sp, gout, a, q, dpre), op.mesh)
        return dc, da, dx, None


class ShardedRank1Gat:
    """Differentiable ``(c, a, x) -> out`` fused rank-1 GAT over the mesh's
    ranks: ``c`` this rank's [row_blk] block of the source
    scalars, ``a`` [d] replicated (its gradient is the whole ``da``),
    ``x`` this rank's [dst_blk, d] block; the output is its [row_blk, d]
    block."""

    def __init__(self, graph: BipartiteGraph, mesh: Mesh,
                 negative_slope: float = 0.2):
        self.graph, self.mesh, self.k = graph, mesh, mesh.world
        sh = shard_rows(graph, self.k, mesh.rank)
        self.row_blk = sh.row_blk
        self.dst_blk = -(-graph.n_dst // self.k)
        self.slope = float(negative_slope)
        self.local = SpmmOperator(shard_graph(sh, self.k * self.dst_blk),
                                  mesh.device)
        self.seed = self.local.ptr.new_zeros(1)

    def __call__(self, c: torch.Tensor, a: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
        _check_rows(x, self.dst_blk, self.mesh.device, "x")
        if c.shape != (self.row_blk,) or a.shape != (x.shape[1],):
            raise ValueError(f"c must be [{self.row_blk}] and a [{x.shape[1]}]"
                             f", got {tuple(c.shape)} and {tuple(a.shape)}")
        return _ShardedRank1Fn.apply(c.contiguous(), a.contiguous(),
                                     x.contiguous(), self)
