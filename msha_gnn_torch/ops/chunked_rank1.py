"""Out-of-core fused rank-1 GAT: the attention layer as one fused kernel a
balanced edge slice, with a cross-slice online-softmax merge
(``msha_gnn_tpu/ops/chunked_rank1.py``).

The function is ``Rank1GatOperator(dst_linear=True)``'s::

    att = softmax_per_sender_row(leaky_relu(c[snd] + (x @ a)[rcv]))
    out[i] = sum_e att_e x[rcv_e]          # rows without edges: 0

The CSR-ordered edges are cut as :mod:`msha_gnn_torch.ops.chunked` cuts
them; each slice keeps its own CSR over the distinct senders it holds.
Forward: ``r1l_fwd_f32`` (``r1l_fwd_bf16`` at ``precision="bf16"``) a
slice gives ``(out_i, lse_i)`` for its rows.  A row split between slices
(only a slice's first row can have been seen before) takes the
online-softmax merge of its pieces: ``lse = logsumexp_i lse_i`` and ``out
= sum_i exp(lse_i - lse) out_i``, a piece with ``lse = NEG`` weighing 0.
The JAX operator merges ``(outa, m, s)`` instead; the port's kernels give
``(out, lse)``, the same state normalised.

Backward, a slice at a time against the merged global ``out`` and ``lse``
(as the JAX operator runs it, ``chunked_rank1.py:294-304``): ``r1l_bwd``
gives ``q``, ``dpre``, the slice's ``dc`` rows (added where slices share a
row) and a ``da`` partial (summed); ``dx`` accumulates the slice's
``q``-weighted transposed ``csr_spmm_f32`` of the float32 cotangent plus
``a`` times the d = 1 column sums of ``dpre``, over the slice's own
receiver-sorted CSR of the distinct receivers it holds (over all of them,
the kernels would zero millions of empty rows a slice one after another on
a power-law graph).  No ``[E, d]`` tensor exists.  At ``precision="bf16"``
``x`` is cast to bfloat16 once a call and shared by every slice; the
cotangent stays float32, as JAX's ``z`` is float32-grade (hi/lo ``gout``,
``rank1_gat.py:366-371``) at both precisions.

Spans (:mod:`msha_gnn_torch.utils.prof`): ``msha.r1gat.fwd`` the forward,
``msha.r1gat.bwd`` the backward and, in it, ``msha.r1gat.bwd.dx`` each
slice's ``dx`` (the ``q`` gather, both transposed SpMMs with the hub rows'
fix-up grids, the ``index_add_``).  Unprofiled, each times its work on
the card by CUDA events; under a profiler each is an annotation of the
trace.

The JAX operator's ``interpret`` is a JAX dispatch option and is left out.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import resolve_device
from ..utils import prof
from .chunked import EdgeSlice, csr_of_sorted, edge_slices
from .cuda.rank1_gat import NEG, r1l_bwd, r1l_fwd
from .cuda.spmm import chunk_runs, crossing_spans, csr_spmm, run_for
from .sparse import PRECISIONS


class _RankSlice:
    """An :class:`~.chunked.EdgeSlice` (``row0`` its first sender) with the
    receiver-sorted CSR of its ``dx`` sums over the distinct receivers it
    holds: ``t_rows`` (int64), ``t_ptr`` [len(t_rows) + 1], ``t_col`` the
    global senders, ``t_edge`` the slice-local edge ids, in (receiver,
    sender) order.  ``spans``: ``spmm.crossing_spans`` of ``t_ptr`` for
    the two ``dx`` sums, at d = 1 and at d > 1."""

    def __init__(self, sl: EdgeSlice, s: np.ndarray, r: np.ndarray,
                 device: torch.device):
        self.sl, self.row0 = sl, int(s[0])
        order = np.argsort(r, kind="stable")   # s is sorted: (r, s) order
        t_rows, t_ptr = csr_of_sorted(r[order])
        self.spans = [crossing_spans(t_ptr, run_for(len(s), d),
                                     chunk_runs(d)) for d in (1, 2)]

        def put(a, dtype=np.int32):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
                device)

        self.t_rows, self.t_ptr = put(t_rows, np.int64), put(t_ptr)
        self.t_col, self.t_edge = put(s[order]), put(order)


def _merge_first_row(out, lse, rs: _RankSlice, o: torch.Tensor,
                     l: torch.Tensor) -> None:
    """Writes a slice's rows ``(o, l)`` into ``(out, lse)``: rows after the
    first are the slice's alone, the first merges with what earlier slices
    left there (0 and NEG where none did)."""
    rest, row0 = rs.sl.rows[1:], rs.row0
    out.index_copy_(0, rest, o[1:])
    lse.index_copy_(0, rest, l[1:])
    l_old, l_new = lse[row0], l[0]
    m = torch.logaddexp(l_old, l_new)
    w_old = torch.where(l_old > NEG / 2, torch.exp(l_old - m), 0.0)
    w_new = torch.where(l_new > NEG / 2, torch.exp(l_new - m), 0.0)
    out[row0] = w_old * out[row0] + w_new * o[0]
    lse[row0] = m


class _ChunkedFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, c, a, x, op):
        xk = x.to(torch.bfloat16) if op.precision == "bf16" else x.float()
        out, lse = op.forward_state(c, a, xk)
        ctx.op = op
        ctx.save_for_backward(c, a, xk, out, lse)
        return out

    @staticmethod
    def backward(ctx, gout):
        c, a, xk, out, lse = ctx.saved_tensors
        return (*ctx.op.backward_state(c, a, xk, out, lse,
                                       gout.float().contiguous()), None)


class ChunkedRank1Gat:
    """``(c, a, x) -> [n_src, d]`` fused rank-1 GAT over host COO edges,
    sliced into ``num_slices`` balanced ranges of CSR edges
    (``chunked_rank1.py::ChunkedRank1Gat``).

    ``c`` [n_src], ``a`` [d], ``x`` [n_dst, d] float32; differentiable in
    all three.  Edges are sorted by sender (stable) unless
    ``assume_sorted``.  ``precision="bf16"`` streams ``x`` in bfloat16
    (``r1l_fwd_bf16``, ``r1l_bwd_bf16``), every sum float32.
    ``long_crossings`` and ``longest_crossing_runs`` (plain integers, at
    d = 1 and at d > 1) count the ``dx`` sums' receivers whose edges span
    more runs than one chunk of their fix-up holds, and the most runs one
    spans, over the slices (``spmm.crossing_spans``).
    """

    def __init__(self, senders, receivers, *, n_src: int, n_dst: int,
                 num_slices: int, negative_slope: float = 0.2,
                 assume_sorted: bool = False, precision: str = "f32",
                 device="cuda"):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r} (f32 | bf16)")
        self.device = resolve_device(device)
        self.precision = precision
        self.n_src, self.n_dst = int(n_src), int(n_dst)
        self.slope = float(negative_slope)
        s = np.ascontiguousarray(senders, np.int32)
        r = np.ascontiguousarray(receivers, np.int32)
        if not assume_sorted:
            order = np.argsort(s, kind="stable")
            s, r = s[order], r[order]
        self.num_edges = len(s)
        if self.num_edges >= 2**31:
            raise ValueError(f"{self.num_edges} edges overflow the kernels' "
                             "int32 offsets")
        self.num_slices = int(num_slices)
        self.slices: List[_RankSlice] = [
            _RankSlice(sl, s[sl.lo:sl.hi], r[sl.lo:sl.hi], self.device)
            for sl in edge_slices(s, r, self.num_slices, self.device)]
        # the dx sums' rows that only the fix-up's second level adds up, and
        # the most runs one row spans, over the slices: at d = 1 and d > 1
        self.long_crossings = tuple(
            sum(rs.spans[i][0] for rs in self.slices) for i in (0, 1))
        self.longest_crossing_runs = tuple(
            max((rs.spans[i][1] for rs in self.slices), default=0)
            for i in (0, 1))
        self._seed = torch.zeros(1, dtype=torch.int32, device=self.device)

    def forward_state(self, c, a, xk):
        """``(out [n_src, d], lse [n_src])`` float32 of the merged slices,
        no autograd; ``xk`` the rows as the kernels read them.  Span
        ``msha.r1gat.fwd``."""
        with prof.span("msha.r1gat.fwd", self.device):
            out = torch.zeros((self.n_src, xk.shape[1]), dtype=torch.float32,
                              device=self.device)
            lse = torch.full((self.n_src,), NEG, dtype=torch.float32,
                             device=self.device)
            for rs in self.slices:
                sl = rs.sl
                o, l = r1l_fwd(sl.ptr, sl.col, c.index_select(0, sl.rows), a,
                               xk, self._seed, 0.0, self.slope, sl.n_rows)
                _merge_first_row(out, lse, rs, o, l)
            return out, lse

    def backward_state(self, c, a, xk, out, lse, gout):
        """``(dc, da, dx)`` for the cotangent ``gout`` of the merged
        ``out``.  Spans ``msha.r1gat.bwd`` (all of it) and, a slice,
        ``msha.r1gat.bwd.dx`` (the slice's ``dx`` after its ``r1l_bwd``)."""
        with prof.span("msha.r1gat.bwd", self.device):
            dc = torch.zeros(self.n_src, dtype=torch.float32,
                             device=self.device)
            da = torch.zeros_like(a)
            dx = torch.zeros((self.n_dst, xk.shape[1]), dtype=torch.float32,
                             device=self.device)
            for rs in self.slices:
                sl = rs.sl
                c_s, g_s, o_s, l_s = (v.index_select(0, sl.rows)
                                      for v in (c, gout, out, lse))
                q, dpre, dc_i, da_i = r1l_bwd(
                    sl.ptr, sl.col, c_s, a, xk, g_s, o_s, l_s, self._seed,
                    0.0, self.slope, sl.n_rows)
                dc.index_add_(0, sl.rows, dc_i)
                da += da_i
                with prof.span("msha.r1gat.bwd.dx", self.device):
                    n_t = rs.t_rows.numel()
                    part = csr_spmm(rs.t_ptr, rs.t_col,
                                    torch.index_select(q, 0, rs.t_edge),
                                    gout, n_t)
                    part.addcmul_(csr_spmm(rs.t_ptr, rs.t_edge, None,
                                           dpre[:, None], n_t), a[None, :])
                    dx.index_add_(0, rs.t_rows, part)
            return dc, da, dx

    def __call__(self, c: torch.Tensor, a: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
        d = x.shape[1] if x.dim() == 2 else -1
        if (c.shape != (self.n_src,) or a.shape != (d,)
                or x.shape != (self.n_dst, d)):
            raise ValueError(f"c {tuple(c.shape)}, a {tuple(a.shape)}, x "
                             f"{tuple(x.shape)} for {self.n_src} x "
                             f"{self.n_dst}")
        if x.device != self.device:
            raise ValueError(f"x is on {x.device}, the operator on "
                             f"{self.device}")
        return _ChunkedFn.apply(c.float().contiguous(),
                                a.float().contiguous(), x.contiguous(), self)
