"""Edge-partitioned distributed SpMM over ``torch.distributed``
(``msha_gnn_tpu/parallel/dist_spmm.py``).

The edges are 1-D partitioned by source row
(:func:`~.partition.partition_edges_by_src`): rank ``i`` owns the CSR row
block ``[i row_blk, (i + 1) row_blk)`` and its edges, so its output rows
are disjoint from every other rank's.  Inputs and outputs are *local*
blocks (:mod:`.comm`): ``A @ x`` takes this rank's block of ``x``'s rows
(``dst_blk = ceil(n_dst / k)`` rows, zero-padded) and gives its block of
the output's (``row_blk`` rows); ``A.T @ x`` takes the source block and
gives the destination block.  :func:`~.comm.scatter_rows` and
:func:`~.comm.gather_rows` go between these blocks and whole tensors.

* :class:`DistributedSpmm`: the forward all-gathers the destination rows
  and reduces its own edges; the transpose forms partial column sums over
  its edges and reduce-scatters them.  The per-shard reduce is
  ``index_add`` of ``index_select``-gathered rows (the JAX package's is
  XLA's ``segment_sum``), so autograd differentiates it (the gather's
  adjoint an ``index_add``, not the sorted accumulate of indexing's, which
  walks a hub receiver's duplicates in one thread group), and the
  collectives' adjoints are the other collective.
* :class:`RingSpmm`: the ring schedule.  Each rank's edges are bucketed by
  the destination block of their receiver (:func:`~msha_gnn_torch.data.
  ring.ring_buckets`); at step ``t`` rank ``i`` holds block ``(i + t) % k``,
  reduces that bucket, and passes the block to rank ``i - 1`` with one
  ``batch_isend_irecv`` (the send and the receive posted together, the
  next block arriving while the bucket reduces).  The transpose passes the
  accumulator of a destination block around the ring instead: after ``k``
  steps rank ``i`` holds its own block's.  At ``k = 1`` there is no
  exchange.  The gradients run the other direction's ring, and ``dw``
  (runtime weights) one more pass of the blocks.

Runtime edge weights (``edge_weight``, attention coefficients) come in the
graph's CSR order, replicated; their gradient is the whole ``dw``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data.ring import ring_buckets
from ..graph import BipartiteGraph
from .comm import (all_gather_rows, copy_to_local, reduce_scatter_rows)
from .mesh import Mesh
from .partition import shard_rows


def _check_rows(x: torch.Tensor, rows: int, device, what: str) -> None:
    if x.device != device:
        raise ValueError(f"{what} is on {x.device}, the operator on {device}")
    if x.dim() != 2 or x.shape[0] != rows:
        raise ValueError(f"{what} must be this rank's [{rows}, d] block, got "
                         f"{tuple(x.shape)}")


class DistributedSpmm:
    """``A @ x`` (and ``A.T @ x``) over the mesh's ranks."""

    def __init__(self, graph: BipartiteGraph, mesh: Mesh):
        self.graph, self.mesh, self.k = graph, mesh, mesh.world
        sh = shard_rows(graph, self.k, mesh.rank)
        self.row_blk = sh.row_blk
        self.dst_blk = -(-graph.n_dst // self.k)
        self._lo, self._hi = sh.lo, sh.hi
        dev = mesh.device
        self.senders = torch.from_numpy(sh.senders).to(dev)
        self.receivers = torch.from_numpy(sh.receivers).to(dev)
        self.weights = torch.from_numpy(sh.weight).to(dev)

    def partition_weights(self, w_csr: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the CSR-order per-edge scalars
        (differentiable: the gradient is the whole ``dw``)."""
        return copy_to_local(w_csr, self.mesh)[self._lo:self._hi].float()

    def __call__(self, x: torch.Tensor, *,
                 edge_weight: Optional[torch.Tensor] = None,
                 transpose: bool = False) -> torch.Tensor:
        """``A @ x``: ``x`` this rank's [dst_blk, d] block -> its [row_blk,
        d] block; ``transpose``: the [row_blk, d] source block -> the
        [dst_blk, d] destination block."""
        w = (self.weights if edge_weight is None
             else self.partition_weights(edge_weight))
        s, r = self.senders, self.receivers
        if transpose:
            _check_rows(x, self.row_blk, self.mesh.device, "x")
            vals = x.index_select(0, s) * w[:, None]
            part = x.new_zeros((self.k * self.dst_blk, x.shape[1]))
            return reduce_scatter_rows(part.index_add(0, r, vals), self.mesh)
        _check_rows(x, self.dst_blk, self.mesh.device, "x")
        x_full = all_gather_rows(x, self.mesh)
        out = x.new_zeros((self.row_blk, x.shape[1]))
        return out.index_add(0, s, x_full.index_select(0, r) * w[:, None])


def _exchange(t: torch.Tensor, mesh: Mesh):
    """Send ``t`` to rank ``i - 1`` and receive the same shape from rank
    ``i + 1``, posted together -> ``(requests, received)``."""
    k, i = mesh.world, mesh.rank
    got = torch.empty_like(t)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, t, mesh.global_rank((i - 1) % k),
                   group=mesh.group),
        dist.P2POp(dist.irecv, got, mesh.global_rank((i + 1) % k),
                   group=mesh.group)])
    return reqs, got


def _rotation(x: torch.Tensor, mesh: Mesh):
    """Yield ``(j, block j)`` for the ``k`` destination blocks, this rank's
    own first: the next block's exchange is posted before the current
    one is handed out, and awaited after."""
    k, i = mesh.world, mesh.rank
    cur = x.contiguous()
    for t in range(k):
        reqs = None
        if t < k - 1:
            reqs, nxt = _exchange(cur, mesh)
        yield (i + t) % k, cur
        if reqs is not None:
            for req in reqs:
                req.wait()
            cur = nxt


class _RingFwd(torch.autograd.Function):
    """``A @ x`` by the ring; ``dx`` the transposed ring of ``g``, ``dw``
    the per-slot dots of ``g``'s rows with each rotated block's."""

    @staticmethod
    def forward(ctx, x, w_b, op):
        ctx.op = op
        ctx.save_for_backward(x, w_b)
        return op._fwd(x, w_b)

    @staticmethod
    def backward(ctx, g):
        x, w_b = ctx.saved_tensors
        op, g = ctx.op, g.contiguous()
        dx = op._t(g, w_b) if ctx.needs_input_grad[0] else None
        dw = op._dots(g, x) if ctx.needs_input_grad[1] else None
        return dx, dw, None


class _RingT(torch.autograd.Function):
    """``A.T @ x`` by the accumulator ring; ``dx`` the forward ring of
    ``g``, ``dw`` the dots of ``x``'s rows with ``g``'s rotated blocks."""

    @staticmethod
    def forward(ctx, x, w_b, op):
        ctx.op = op
        ctx.save_for_backward(x, w_b)
        return op._t(x, w_b)

    @staticmethod
    def backward(ctx, g):
        x, w_b = ctx.saved_tensors
        op, g = ctx.op, g.contiguous()
        dx = op._fwd(g, w_b) if ctx.needs_input_grad[0] else None
        dw = op._dots(x, g) if ctx.needs_input_grad[1] else None
        return dx, dw, None


class RingSpmm:
    """Edge-partitioned SpMM with a ring schedule over the destination
    blocks: no rank ever holds more than one block of ``x`` besides its
    own (the module's docstring).  ``runtime_weights=True`` keeps each
    bucket slot's CSR edge id, so CSR-order ``edge_weight`` can be laid
    out per call (:meth:`partition_weights`)."""

    def __init__(self, graph: BipartiteGraph, mesh: Mesh, *,
                 runtime_weights: bool = False):
        self.graph, self.mesh = graph, mesh
        k, i = mesh.world, mesh.rank
        self.k = k
        self.row_blk = -(-graph.n_src // k)
        self.dst_blk = -(-graph.n_dst // k)
        e = graph.num_edges
        out = ring_buckets(graph.senders[:e].cpu().numpy(),
                           graph.receivers[:e].cpu().numpy(),
                           graph.weight[:e].cpu().numpy(), k, self.row_blk,
                           self.dst_blk, with_inv=runtime_weights)
        dev = mesh.device

        def mine(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a[i])).to(
                device=dev, dtype=dtype)

        self._s_b = mine(out[0], torch.int64)    # [k, e_b], pad row_blk
        self._rl_b = mine(out[1], torch.int64)   # [k, e_b], pad 0
        self._w_b = mine(out[2], torch.float32)  # [k, e_b], pad 0
        self._inv = mine(out[3], torch.int64) if runtime_weights else None
        self._e = e

    def partition_weights(self, w_csr: torch.Tensor) -> torch.Tensor:
        """CSR-order per-edge scalars -> this rank's ``[k, e_b]`` bucket
        layout (pads 0; differentiable).  Needs ``runtime_weights=True``."""
        if self._inv is None:
            raise ValueError("RingSpmm was built without runtime_weights=True")
        w = copy_to_local(w_csr, self.mesh)[:self._e].float()
        return torch.cat([w, w.new_zeros(1)])[self._inv]

    def _fwd(self, x, w_b):
        """``A @ x`` (no autograd): [dst_blk, d] -> [row_blk, d]."""
        acc = x.new_zeros((self.row_blk + 1, x.shape[1]))
        for j, cur in _rotation(x, self.mesh):
            acc.index_add_(0, self._s_b[j], cur.index_select(
                0, self._rl_b[j]) * w_b[j][:, None])
        return acc[:self.row_blk]

    def _t(self, x, w_b):
        """``A.T @ x`` (no autograd): [row_blk, d] -> [dst_blk, d]."""
        k, i = self.k, self.mesh.rank
        x_ext = torch.cat([x, x.new_zeros((1, x.shape[1]))])
        acc = x.new_zeros((self.dst_blk, x.shape[1]))
        for t in range(k):
            j = (i + t) % k
            acc.index_add_(0, self._rl_b[j], x_ext.index_select(
                0, self._s_b[j]) * w_b[j][:, None])
            if k > 1:
                reqs, acc_next = _exchange(acc, self.mesh)
                for req in reqs:
                    req.wait()
                acc = acc_next
        return acc

    def _dots(self, rows, blocks):
        """``dw[j, slot] = <rows[s], block_j[rl]>`` over the rotated
        ``blocks`` ([dst_blk, d] a rank; ``rows`` [row_blk, d])."""
        rows_ext = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])
        dw = rows.new_zeros(self._w_b.shape)
        for j, cur in _rotation(blocks, self.mesh):
            dw[j] = (rows_ext.index_select(0, self._s_b[j])
                     * cur.index_select(0, self._rl_b[j])).sum(1)
        return dw

    def __call__(self, x: torch.Tensor, *,
                 edge_weight: Optional[torch.Tensor] = None,
                 transpose: bool = False) -> torch.Tensor:
        """As :meth:`DistributedSpmm.__call__`."""
        w_b = (self._w_b if edge_weight is None
               else self.partition_weights(edge_weight))
        if transpose:
            _check_rows(x, self.row_blk, self.mesh.device, "x")
            return _RingT.apply(x, w_b, self)
        _check_rows(x, self.dst_blk, self.mesh.device, "x")
        return _RingFwd.apply(x, w_b, self)
