"""Out-of-core SpMM: ``A @ x`` over balanced slices of the edge set
(``msha_gnn_tpu/ops/chunked.py``).

The edges, in CSR order (sorted by sender), are cut into ``num_slices``
contiguous ranges of nearly equal length (``np.linspace`` bounds, as the
JAX operator cuts them).  Each slice keeps its own CSR over the distinct
senders it holds (its rows, in order): a pointer over them and its
receivers as columns.  A pass runs ``csr_spmm_f32``
(:mod:`msha_gnn_torch.ops.cuda.spmm`) once per slice and adds each
slice's rows into the output at their senders; only the boundary row of
two slices is added twice.  No ``[E, d]`` intermediate exists.  A slice's
pointer holds no empty row: over the whole range of rows, a receiver-sorted
slice of a power-law graph (the transposed pass) spans millions of rows
without edges, which the kernels zero one row after another.

:class:`ChunkedSpmm` is differentiable in ``x`` and in a runtime edge
weight given in its CSR order (``apply``): ``dx`` is the chunked pass of
the transposed operator (the edges sorted by receiver, sliced anew) and
``dw`` one ``csr_sddmm_f32`` per slice (``_sddmm_visits_raw``'s port).

The JAX operator's ``interpret`` (Pallas interpret mode) and ``fused``
(one ``lax.scan`` dispatch over the slices against a loop of jitted
calls) are JAX dispatch options and are left out: here the slices always
run as a loop of launches.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, List, Optional

import numpy as np
import torch

from .. import resolve_device
from .cuda.sddmm import csr_sddmm
from .cuda.spmm import csr_spmm, widen

if TYPE_CHECKING:
    from ..graph import BipartiteGraph


@dataclasses.dataclass
class EdgeSlice:
    """One slice: the CSR edges ``[lo, hi)``, the distinct senders they hold
    (``rows`` int64, ascending), and the slice's own CSR over those rows
    (``ptr`` [n_rows + 1] from 0, ``col`` [hi - lo] the receivers, int32),
    on the operator's device."""

    lo: int
    hi: int
    rows: torch.Tensor
    ptr: torch.Tensor
    col: torch.Tensor

    @property
    def n_rows(self) -> int:
        return self.rows.numel()


def slice_bounds(num_edges: int, num_slices: int) -> List[tuple]:
    """The ``[lo, hi)`` edge ranges of ``num_slices`` balanced slices
    (``ops/chunked.py:171-173``)."""
    if num_slices < 1:
        raise ValueError(f"num_slices must be >= 1, got {num_slices}")
    b = np.linspace(0, num_edges, num_slices + 1).astype(np.int64)
    return [(int(b[i]), int(b[i + 1])) for i in range(num_slices)]


def csr_of_sorted(keys: np.ndarray):
    """``(rows, ptr)`` of sorted keys: the distinct keys and the offsets of
    their runs (``ptr`` [len(rows) + 1] from 0)."""
    starts = np.flatnonzero(np.diff(keys)) + 1
    ptr = np.concatenate([[0], starts, [len(keys)]]).astype(np.int32)
    return keys[ptr[:-1]].astype(np.int64), ptr


def edge_slices(senders: np.ndarray, receivers: np.ndarray, num_slices: int,
                device: torch.device) -> List[EdgeSlice]:
    """The non-empty slices of CSR-ordered host edges, each with its CSR
    over its distinct senders on ``device``."""
    out = []
    for lo, hi in slice_bounds(len(senders), num_slices):
        if hi == lo:
            continue
        rows, ptr = csr_of_sorted(senders[lo:hi])
        out.append(EdgeSlice(
            lo, hi, torch.from_numpy(rows).to(device),
            torch.from_numpy(ptr).to(device),
            torch.from_numpy(np.ascontiguousarray(receivers[lo:hi],
                                                  np.int32)).to(device)))
    return out


class _ApplyFn(torch.autograd.Function):
    """``A(w) @ x`` with ``dx = A(w).T @ g`` by the transposed operator's
    chunked pass and ``dw_e = <g[s_e], x[r_e]>`` by one ``csr_sddmm_f32`` a
    slice (CSR order, the pads past the edges 0)."""

    @staticmethod
    def forward(ctx, x, w, op):
        ctx.op = op
        ctx.save_for_backward(x, w)
        return op._pass(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        op, g = ctx.op, g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            t = op._transpose_op()
            dx = t._pass(g, w[: op.num_edges][t.input_perm])
        if ctx.needs_input_grad[1]:
            xw = widen(x)
            dw = torch.zeros_like(w)
            for sl in op.slices:
                dw[sl.lo:sl.hi] = csr_sddmm(sl.ptr, sl.col,
                                            g.index_select(0, sl.rows), xw,
                                            sl.hi - sl.lo)
        return dx, dw, None


class ChunkedSpmm:
    """``A @ x`` over an edge-sliced graph (``ops/chunked.py::ChunkedSpmm``),
    for graphs whose gathered ``[E, d]`` rows would not fit the card.

    ``ChunkedSpmm(graph, num_slices)`` slices a :class:`BipartiteGraph`'s
    edges on the graph's device; :meth:`from_host_coo` builds from host COO
    arrays, so that only the slices' arrays reach the device.
    ``op(x)`` is ``A @ x`` with the graph's weights, ``op(x,
    edge_weight=w)`` with runtime weights in this operator's CSR order (the
    input order of :meth:`from_host_coo`), ``transpose=True`` ``A.T @ x``;
    all differentiable.  ``x`` may be bfloat16 (``csr_spmm_bf16`` a slice;
    the gradients are float32).
    """

    def __init__(self, graph: Optional["BipartiteGraph"], num_slices: int,
                 *, device=None, _host=None):
        if _host is None:
            e = graph.num_edges
            _host = (graph.senders[:e].cpu().numpy(),
                     graph.receivers[:e].cpu().numpy(),
                     graph.weight[:e].cpu().numpy(), graph.n_src, graph.n_dst)
            device = graph.device if device is None else device
        s, r, w, n_src, n_dst = _host
        self._host = _host
        self.device = resolve_device("cuda" if device is None else device)
        self.n_src, self.n_dst = int(n_src), int(n_dst)
        self.num_edges = len(s)
        if self.num_edges >= 2**31:
            raise ValueError(f"{self.num_edges} edges overflow the kernels' "
                             "int32 offsets")
        self.num_slices = int(num_slices)
        self.bounds = slice_bounds(self.num_edges, self.num_slices)
        self.slices = edge_slices(s, r, self.num_slices, self.device)
        self.weight = torch.from_numpy(
            np.ascontiguousarray(w, np.float32)).to(self.device)
        # input order -> this operator's CSR order (from_host_coo)
        self.input_perm: Optional[torch.Tensor] = None
        self._t: Optional["ChunkedSpmm"] = None

    @classmethod
    def from_host_coo(cls, senders, receivers, weight, *, n_src: int,
                      n_dst: int, num_slices: int,
                      assume_sorted: bool = False,
                      device="cuda") -> "ChunkedSpmm":
        """Build from host COO arrays; the edges are put in CSR order by a
        stable sort on the sender unless ``assume_sorted``.  ``weight``
        None means unit weights.  ``op.input_perm`` maps this operator's
        CSR positions to the input's (None when already sorted)."""
        s = np.ascontiguousarray(senders, np.int32)
        r = np.ascontiguousarray(receivers, np.int32)
        w = (np.ones(len(s), np.float32) if weight is None
             else np.ascontiguousarray(weight, np.float32))
        order = None
        if not assume_sorted:
            order = np.argsort(s, kind="stable")
            s, r, w = s[order], r[order], w[order]
        op = cls(None, num_slices, device=device,
                 _host=(s, r, w, int(n_src), int(n_dst)))
        if order is not None:
            op.input_perm = torch.from_numpy(order).to(op.device)
        return op

    def _transpose_op(self) -> "ChunkedSpmm":
        if self._t is None:
            s, r, w, n_src, n_dst = self._host
            self._t = ChunkedSpmm.from_host_coo(
                r, s, w, n_src=n_dst, n_dst=n_src,
                num_slices=self.num_slices, device=self.device)
        return self._t

    def _pass(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``A(w) @ x`` -> [n_src, d] float32: one ``csr_spmm`` a slice
        over its rows, no autograd."""
        x, w = x.contiguous(), w.float().contiguous()
        out = torch.zeros((self.n_src, x.shape[1]), dtype=torch.float32,
                          device=self.device)
        for sl in self.slices:
            out.index_add_(0, sl.rows, csr_spmm(sl.ptr, sl.col,
                                                w[sl.lo:sl.hi], x,
                                                sl.n_rows))
        return out

    def partition_weights(self, w: torch.Tensor) -> torch.Tensor:
        """CSR-order per-edge scalars [>= E] -> the stacked slice layout
        [num_slices, E_max], each slice's weights then zeros."""
        w = w[: self.num_edges].float()
        e_max = max(hi - lo for lo, hi in self.bounds)
        out = w.new_zeros((self.num_slices, e_max))
        for i, (lo, hi) in enumerate(self.bounds):
            out[i, : hi - lo] = w[lo:hi]
        return out

    def apply(self, x: torch.Tensor, edge_weight: torch.Tensor
              ) -> torch.Tensor:
        """Differentiable ``A(edge_weight) @ x`` for per-edge weights in this
        operator's CSR order (e.g. attention): ``dx`` by the transposed
        chunked pass, ``dw`` by the chunked SDDMM (the out-of-core training
        path)."""
        if x.device != self.device or x.dim() != 2 or \
                x.shape[0] != self.n_dst:
            raise ValueError(f"x must be [{self.n_dst}, d] on {self.device}, "
                             f"got {tuple(x.shape)} on {x.device}")
        if edge_weight.dim() != 1 or edge_weight.shape[0] < self.num_edges:
            raise ValueError(f"edge_weight must be [>= {self.num_edges}], "
                             f"got {tuple(edge_weight.shape)}")
        return _ApplyFn.apply(x, edge_weight, self)

    def __call__(self, x: torch.Tensor, *,
                 edge_weight: Optional[torch.Tensor] = None,
                 transpose: bool = False) -> torch.Tensor:
        if transpose:
            t = self._transpose_op()
            if edge_weight is None:
                return t(x)
            return t.apply(x, edge_weight[: self.num_edges][t.input_perm])
        return self.apply(x, self.weight if edge_weight is None
                          else edge_weight)


def spmm_out_of_core(graph: "BipartiteGraph", x: torch.Tensor, *,
                     num_slices: int) -> torch.Tensor:
    """One-shot ``A @ x`` over ``num_slices`` edge slices (prefer a
    :class:`ChunkedSpmm` in loops)."""
    return ChunkedSpmm(graph, num_slices)(x)
