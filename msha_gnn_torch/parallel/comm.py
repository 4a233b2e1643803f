"""Collectives over a mesh's ranks, and their autograd forms.

A tensor in this package is either *replicated* (every rank holds the
same whole tensor) or *local* (each rank holds its own block or its own
partial sum).  The gradient of a replicated tensor is, on every rank, the
whole gradient; that of a local tensor is the gradient of the rank's
block.  Six differentiable crossings keep that true, so that a loss
formed the same way on every rank gives every rank the single-device
gradients:

=========================  ======================  =====================
op                          forward                 backward
=========================  ======================  =====================
:func:`all_gather_rows`     local block -> all      reduce-scatter
:func:`reduce_scatter_rows` local partial -> block  all-gather
:func:`scatter_rows`        replicated -> block     all-gather
:func:`gather_rows`         block -> replicated     own block
:func:`reduce_from_local`   local partial -> sum    identity
:func:`copy_to_local`       replicated, identity    all-reduce
=========================  ======================  =====================

``copy_to_local`` marks a replicated tensor that enters a local
computation (its gradient there is a partial sum); ``reduce_from_local``
sums local partials into a replicated result.  The plain collectives
(:func:`all_gather`, :func:`reduce_scatter`, :func:`all_reduce`) run on
the mesh's group and raise on any failure.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .mesh import Mesh

# the single-tensor collectives' names of newer torch releases, else the
# older ones (the same operations)
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``[blk, ...]`` from every rank -> ``[k blk, ...]`` in rank order."""
    x = x.contiguous()
    out = x.new_empty((mesh.world * x.shape[0], *x.shape[1:]))
    _ALL_GATHER(out, x, group=mesh.group)
    return out


def reduce_scatter(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``[k blk, ...]`` partial sums from every rank -> this rank's block of
    their sum."""
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // mesh.world, *x.shape[1:]))
    _REDUCE_SCATTER(out, x, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks (a new tensor)."""
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.mesh), None


class _ReduceScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return reduce_scatter(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh), None


class _ReduceFromLocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToLocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh), None


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``[blk, ...]`` block -> ``[k blk, ...]``; the gradient
    is reduce-scattered back to the blocks."""
    return _AllGatherRows.apply(x, mesh)


def reduce_scatter_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``[k blk, ...]`` partial -> this rank's block of the
    sum; the gradient is all-gathered."""
    return _ReduceScatterRows.apply(x, mesh)


def reduce_from_local(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Local partial sums -> their replicated sum."""
    return _ReduceFromLocal.apply(x, mesh)


def copy_to_local(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A replicated tensor as an input of a local computation: the
    identity, whose gradient is summed over the ranks."""
    return _CopyToLocal.apply(x, mesh)


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, pad):
        n = x.shape[0]
        lo, hi, blk = mesh.block(n)
        ctx.mesh, ctx.n, ctx.lo, ctx.hi, ctx.blk = mesh, n, lo, hi, blk
        out = x[lo:hi]
        if pad and hi - lo < blk:
            return F.pad(out, (0, 0) * (x.dim() - 1) + (0, blk - (hi - lo)))
        return out.clone()

    @staticmethod
    def backward(ctx, g):
        blk, rows = ctx.blk, ctx.hi - ctx.lo
        g = g[:rows]
        if rows < blk:
            g = F.pad(g, (0, 0) * (g.dim() - 1) + (0, blk - rows))
        return all_gather(g, ctx.mesh)[:ctx.n], None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n, mesh):
        lo, hi, blk = mesh.block(n)
        ctx.lo, ctx.hi, ctx.shape = lo, hi, x.shape
        x = x[:hi - lo]
        if hi - lo < blk:
            x = F.pad(x, (0, 0) * (x.dim() - 1) + (0, blk - (hi - lo)))
        return all_gather(x, mesh)[:n]

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros(ctx.shape)
        out[:ctx.hi - ctx.lo] = g[ctx.lo:ctx.hi]
        return out, None, None


def scatter_rows(x: torch.Tensor, mesh: Mesh, pad: bool = True
                 ) -> torch.Tensor:
    """This rank's block of the rows of the replicated ``x`` (padded with
    zero rows to the block length when ``pad``)."""
    return _ScatterRows.apply(x, mesh, pad)


def gather_rows(x: torch.Tensor, n: int, mesh: Mesh) -> torch.Tensor:
    """Every rank's block (its first ``hi - lo`` rows; a padded block's
    tail is ignored) -> the replicated ``[n, ...]``."""
    return _GatherRows.apply(x, n, mesh)


def take_global_rows(x: torch.Tensor, rows: torch.Tensor, n: int,
                     mesh: Mesh) -> torch.Tensor:
    """``X[rows]`` (replicated) of the row-sharded ``X`` [n, ...] whose
    block this rank holds as ``x``: each rank fills the rows it owns and
    the partials are summed."""
    lo, hi, _ = mesh.block(n)
    rows = rows.long()
    own = (rows >= lo) & (rows < hi)
    idx = torch.where(own, rows - lo, 0)
    if x.shape[0] == 0:
        part = x.new_zeros((rows.shape[0], *x.shape[1:]))
    else:
        mask = own.reshape(-1, *([1] * (x.dim() - 1)))
        part = torch.where(mask, x[idx], 0.0)
    return reduce_from_local(part, mesh)
