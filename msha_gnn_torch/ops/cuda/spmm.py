"""CSR SpMM through the hand-written kernel ``csr_spmm_f32``
(``msha_gnn_torch/csrc/spmm.cu``).

The kernel replaces two TPU kernels of ``msha_gnn_tpu/ops/pallas/spmm.py``,
``_visit_kernel`` and ``_hub_kernel``; the source says why one kernel
serves both and what bounds it (bytes).

* :func:`csr_spmm` is the kernel's wrapper: it checks its inputs, launches
  on the current stream and counts the launch in :data:`launches`.  For
  tensors on the CPU it runs :func:`csr_spmm_plain`, the plain PyTorch
  version of the same function, which is also the kernel's oracle.
* :class:`SpmmOperator` binds one graph: it builds the CSR arrays of ``A``
  and the CSC arrays of ``A.T`` once, as the JAX operator builds its two
  directions, and keeps the CSC->CSR edge permutation so runtime weights
  given in CSR order reach the transpose.  Its gradient with respect to
  ``x`` is the transposed launch of the same kernel, as the JAX operator's
  VJP is (``spmm.py:1599-1682``).  The gradient of a runtime edge weight
  needs the SDDMM kernels, which are not ported yet: on CUDA such a weight
  raises rather than silently returning no gradient.
* :meth:`SpmmOperator.reduce_edges` sums per-edge rows into their
  receivers, ``out[j] = sum_{e: rcv_e = j} z[e]``: the kernel over the CSC
  pointer with the CSC->CSR edge ids as columns and no weights, which the
  kernel reads as unit weights (the rank-1 GAT backward's ``dx``,
  ``_reduce_z`` in the JAX package).
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from ... import resolve_device

if TYPE_CHECKING:
    from ...graph import BipartiteGraph

MAX_WARPS = 8

# Launches of csr_spmm_f32 in this process (a plain count, reset by callers
# that measure a run).
launches = 0

_lib: Optional[ctypes.CDLL] = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("spmm")
        lib.csr_spmm_f32.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.csr_spmm_f32.restype = ctypes.c_int
        lib.csr_spmm_error_string.argtypes = [ctypes.c_int]
        lib.csr_spmm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def warps_for(num_edges: int, n_rows: int, max_row: int = 0) -> int:
    """Warps per block, 1..8: about one warp per 32 edges of a mean row,
    and at least one per 512 edges of the longest row, whose block
    otherwise sets the time of a skewed graph alone."""
    mean = num_edges / max(n_rows, 1)
    return int(min(MAX_WARPS, max(1, round(mean / 32), -(-max_row // 512))))


def csr_spmm_plain(ptr: torch.Tensor, col: torch.Tensor,
                   w: Optional[torch.Tensor], x: torch.Tensor,
                   n_rows: int) -> torch.Tensor:
    """Plain version: gather the rows, scale, ``index_add_`` into rows."""
    rows = torch.repeat_interleave(
        torch.arange(n_rows, device=x.device), (ptr[1:] - ptr[:-1]).long(),
        output_size=col.numel(),
    )
    out = x.new_zeros((n_rows, x.shape[1]))
    vals = x[col.long()]
    return out.index_add_(0, rows, vals if w is None else w[:, None] * vals)


def csr_spmm(ptr: torch.Tensor, col: torch.Tensor, w: Optional[torch.Tensor],
             x: torch.Tensor, n_rows: int, n_warps: int) -> torch.Tensor:
    """``out[r] = sum_{e in row r} w[e] * x[col[e]]`` -> [n_rows, d] f32.

    ``ptr`` int32 [n_rows + 1], ``col`` int32 [E], ``w`` f32 [E] or None
    for unit weights, ``x`` f32 [n_cols, d], all contiguous and on one
    device; ``n_warps`` per block
    (1..8, see :func:`warps_for`).  CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise.
    """
    global launches
    dev = x.device
    given = [("ptr", ptr), ("col", col), ("x", x)]
    if w is not None:
        given.append(("w", w))
    for name, t in given:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if dev.type == "cpu":
        return csr_spmm_plain(ptr, col, w, x, n_rows)
    if dev.type != "cuda":
        raise ValueError(f"csr_spmm runs on cuda or cpu, not {dev}")
    if ptr.dtype != torch.int32 or col.dtype != torch.int32:
        raise TypeError("ptr and col must be int32")
    if x.dtype != torch.float32 or (w is not None
                                    and w.dtype != torch.float32):
        raise TypeError("w and x must be float32")
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got {tuple(x.shape)}")
    if ptr.shape != (n_rows + 1,) or col.dim() != 1 or (
            w is not None and w.shape != col.shape):
        raise ValueError(
            f"shapes: ptr {tuple(ptr.shape)} for {n_rows} rows, "
            f"col {tuple(col.shape)}, "
            f"w {None if w is None else tuple(w.shape)}")
    for name, t in given:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    d = x.shape[1]
    out = torch.empty((n_rows, d), dtype=torch.float32, device=dev)
    if n_rows == 0 or d == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.csr_spmm_f32(ptr.data_ptr(), col.data_ptr(),
                              None if w is None else w.data_ptr(),
                              x.data_ptr(), out.data_ptr(), n_rows, d,
                              n_warps, stream)
    if rc != 0:
        msg = lib.csr_spmm_error_string(rc).decode()
        raise RuntimeError(f"csr_spmm_f32 launch failed: {msg} (error {rc})")
    launches += 1
    return out


class SpmmOperator:
    """``A @ x`` and ``A.T @ x`` for one graph, on one device.

    ``launches`` counts this operator's kernel launches and
    ``launches_transposed`` those of them that ran ``A.T``.
    """

    def __init__(self, graph: "BipartiteGraph", device="cuda"):
        self.device = resolve_device(device)
        self.graph = graph
        e = graph.num_edges
        if e >= 2**31:
            raise ValueError(f"{e} edges overflow the kernel's int32 offsets")
        s = graph.senders[:e].cpu().numpy()
        r = graph.receivers[:e].cpu().numpy()
        w = graph.weight[:e].cpu().numpy().astype(np.float32)
        # CSC: the same edges sorted by (receiver, sender)
        order = np.lexsort((s, r))
        csc_ptr = np.zeros(graph.n_dst + 1, np.int64)
        csc_ptr[1:] = np.bincount(r, minlength=graph.n_dst)
        dev = self.device

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        self.ptr = put(graph.row_ptr.cpu().numpy(), np.int32)
        self.col = put(r, np.int32)
        self.w = put(w, np.float32)
        self.t_ptr = put(np.cumsum(csc_ptr), np.int32)
        self.t_col = put(s[order], np.int32)
        self.t_w = put(w[order], np.float32)
        self.t_edge = put(order, np.int32)  # CSC position -> CSR edge id
        self.num_edges = e
        row_len = np.diff(graph.row_ptr.cpu().numpy())
        self.warps = warps_for(e, graph.n_src, int(row_len.max(initial=0)))
        self.warps_t = warps_for(e, graph.n_dst, int(csc_ptr.max(initial=0)))
        self.launches = 0
        self.launches_transposed = 0

    def _launch(self, ptr, col, w, x, n_out, warps, transpose):
        before = launches
        out = csr_spmm(ptr, col, w, x, n_out, warps)
        if launches != before:
            self.launches += 1
            self.launches_transposed += int(transpose)
        return out

    def _weights(self, edge_weight, transpose):
        if edge_weight is None:
            return self.t_w if transpose else self.w
        if transpose:
            return edge_weight[self.t_edge].contiguous()
        return edge_weight[: self.num_edges].contiguous()

    def apply(self, x: torch.Tensor, w: torch.Tensor, w_t: torch.Tensor,
              transpose: bool) -> torch.Tensor:
        """``A @ x`` (``A.T @ x`` when ``transpose``) for CSR-order weights
        ``w`` and their CSC-order copy ``w_t``; no autograd."""
        g = self.graph
        if transpose:
            return self._launch(self.t_ptr, self.t_col, w_t, x, g.n_dst,
                                self.warps_t, True)
        return self._launch(self.ptr, self.col, w, x, g.n_src, self.warps,
                            False)

    def __call__(self, x: torch.Tensor, *,
                 edge_weight: Optional[torch.Tensor] = None,
                 transpose: bool = False) -> torch.Tensor:
        g = self.graph
        if x.device != self.device:
            raise ValueError(f"x is on {x.device}, the operator on "
                             f"{self.device}")
        n_in = g.n_src if transpose else g.n_dst
        if x.dim() != 2 or x.shape[0] != n_in:
            raise ValueError(f"x must be [{n_in}, d], got {tuple(x.shape)}")
        weight_grad = (edge_weight is not None and edge_weight.requires_grad
                       and torch.is_grad_enabled())
        if weight_grad and x.is_cuda:
            raise NotImplementedError(
                "the gradient of a runtime edge weight needs the SDDMM "
                "kernels _sddmm_kernel and _sddmm_hub_kernel "
                "(msha_gnn_tpu/ops/pallas/spmm.py:1428, :1294), which are "
                "not ported yet")
        if weight_grad:  # the CPU: the plain version's own autograd
            return self.apply(x, self._weights(edge_weight, False),
                              self._weights(edge_weight, True), transpose)
        ew = None if edge_weight is None else edge_weight.detach()
        return _SpmmFn.apply(x, self._weights(ew, False),
                             self._weights(ew, True), self, transpose)

    def reduce_edges(self, z: torch.Tensor) -> torch.Tensor:
        """``out[j] = sum_{e: rcv_e = j} z[e]`` -> [n_dst, d], for ``z``
        [num_edges, d] in CSR edge order; one transposed kernel launch."""
        if z.device != self.device:
            raise ValueError(f"z is on {z.device}, the operator on "
                             f"{self.device}")
        if z.dim() != 2 or z.shape[0] != self.num_edges:
            raise ValueError(f"z must be [{self.num_edges}, d], got "
                             f"{tuple(z.shape)}")
        return self._launch(self.t_ptr, self.t_edge, None, z.contiguous(),
                            self.graph.n_dst, self.warps_t, True)


class _SpmmFn(torch.autograd.Function):
    """``A @ x`` with ``dx = A.T @ g``, and ``A.T @ x`` with ``dx = A @ g``:
    the backward is the other direction's launch of the same kernel."""

    @staticmethod
    def forward(ctx, x, w, w_t, op, transpose):
        ctx.op, ctx.transpose = op, transpose
        ctx.save_for_backward(w, w_t)
        return op.apply(x, w, w_t, transpose)

    @staticmethod
    def backward(ctx, g):
        w, w_t = ctx.saved_tensors
        dx = ctx.op.apply(g.contiguous(), w, w_t, not ctx.transpose)
        return dx, None, None, None, None


# One operator per graph, so repeated layer calls share the CSR/CSC build.
_OPS: dict = {}


def operator_for(graph: "BipartiteGraph") -> SpmmOperator:
    """The cached :class:`SpmmOperator` of ``graph``, on its device."""
    entry = _OPS.get(id(graph))
    if entry is None or entry[0] is not graph:
        entry = (graph, SpmmOperator(graph, graph.device))
        _OPS[id(graph)] = entry
        if len(_OPS) > 16:
            _OPS.pop(next(iter(_OPS)))
    return entry[1]


def spmm_cuda(graph: "BipartiteGraph", x: torch.Tensor, *,
              edge_weight: Optional[torch.Tensor] = None,
              transpose: bool = False) -> torch.Tensor:
    """``spmm(..., impl="cuda")``: the graph's operator applied to ``x``."""
    return operator_for(graph)(x, edge_weight=edge_weight,
                               transpose=transpose)
