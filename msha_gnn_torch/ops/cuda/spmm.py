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
  given in CSR order reach the transpose.  It is forward only: the backward
  lands with the training slice, and until then a CUDA input that requires
  grad raises rather than silently returning no gradient.
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


def warps_for(num_edges: int, n_rows: int) -> int:
    """Warps per block: about one warp per 32 edges of a mean row, 1..8."""
    mean = num_edges / max(n_rows, 1)
    return int(min(MAX_WARPS, max(1, round(mean / 32))))


def csr_spmm_plain(ptr: torch.Tensor, col: torch.Tensor, w: torch.Tensor,
                   x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Plain version: gather the rows, scale, ``index_add_`` into rows."""
    rows = torch.repeat_interleave(
        torch.arange(n_rows, device=x.device), (ptr[1:] - ptr[:-1]).long(),
        output_size=col.numel(),
    )
    out = x.new_zeros((n_rows, x.shape[1]))
    return out.index_add_(0, rows, w[:, None] * x[col.long()])


def csr_spmm(ptr: torch.Tensor, col: torch.Tensor, w: torch.Tensor,
             x: torch.Tensor, n_rows: int, n_warps: int) -> torch.Tensor:
    """``out[r] = sum_{e in row r} w[e] * x[col[e]]`` -> [n_rows, d] f32.

    ``ptr`` int32 [n_rows + 1], ``col`` int32 [E], ``w`` f32 [E], ``x`` f32
    [n_cols, d], all contiguous and on one device; ``n_warps`` per block
    (1..8, see :func:`warps_for`).  CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise.
    """
    global launches
    dev = x.device
    for name, t in (("ptr", ptr), ("col", col), ("w", w)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if dev.type == "cpu":
        return csr_spmm_plain(ptr, col, w, x, n_rows)
    if dev.type != "cuda":
        raise ValueError(f"csr_spmm runs on cuda or cpu, not {dev}")
    if ptr.dtype != torch.int32 or col.dtype != torch.int32:
        raise TypeError("ptr and col must be int32")
    if w.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError("w and x must be float32")
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got {tuple(x.shape)}")
    if ptr.shape != (n_rows + 1,) or col.dim() != 1 or w.shape != col.shape:
        raise ValueError(
            f"shapes: ptr {tuple(ptr.shape)} for {n_rows} rows, "
            f"col {tuple(col.shape)}, w {tuple(w.shape)}")
    for name, t in (("ptr", ptr), ("col", col), ("w", w), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    d = x.shape[1]
    out = torch.empty((n_rows, d), dtype=torch.float32, device=dev)
    if n_rows == 0 or d == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.csr_spmm_f32(ptr.data_ptr(), col.data_ptr(), w.data_ptr(),
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
        self.csc_to_csr = put(order, np.int64)
        self.num_edges = e
        self.warps = warps_for(e, graph.n_src)
        self.warps_t = warps_for(e, graph.n_dst)
        self.launches = 0
        self.launches_transposed = 0

    def __call__(self, x: torch.Tensor, *,
                 edge_weight: Optional[torch.Tensor] = None,
                 transpose: bool = False) -> torch.Tensor:
        g = self.graph
        if x.device != self.device:
            raise ValueError(f"x is on {x.device}, the operator on "
                             f"{self.device}")
        if x.is_cuda and torch.is_grad_enabled() and (
                x.requires_grad
                or (edge_weight is not None and edge_weight.requires_grad)):
            raise NotImplementedError("backward lands with the training slice")
        n_in, n_out = (g.n_src, g.n_dst) if transpose else (g.n_dst, g.n_src)
        if x.dim() != 2 or x.shape[0] != n_in:
            raise ValueError(f"x must be [{n_in}, d], got {tuple(x.shape)}")
        if transpose:
            ptr, col, warps = self.t_ptr, self.t_col, self.warps_t
            w = (self.t_w if edge_weight is None
                 else edge_weight[self.csc_to_csr].contiguous())
        else:
            ptr, col, warps = self.ptr, self.col, self.warps
            w = (self.w if edge_weight is None
                 else edge_weight[: self.num_edges].contiguous())
        before = launches
        out = csr_spmm(ptr, col, w, x, n_out, warps)
        if launches != before:
            self.launches += 1
            self.launches_transposed += int(transpose)
        return out


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
