"""Per-edge dot products through the hand-written kernel ``csr_sddmm_f32``
(``msha_gnn_torch/csrc/sddmm.cu``).

The kernel replaces ``_sddmm_kernel`` and ``_sddmm_hub_kernel`` of
``msha_gnn_tpu/ops/pallas/spmm.py``; the source says why one kernel serves
both and what bounds it (bytes).

* :func:`csr_sddmm` is the kernel's wrapper: it checks its inputs, launches
  on the current stream and counts the launch in :data:`launches`.  For
  tensors on the CPU it runs :func:`csr_sddmm_plain`, the plain PyTorch
  version of the same function and the kernel's oracle.
  :func:`csr_sddmm_runs_plain` mirrors the kernel's edge-run walk (the one
  of ``csrc/gat_bwd.cuh``, shared with ``flash_bwd_f32`` and
  ``r1_bwd_f32``) step by step, for tests.
* :class:`SddmmOperator` (``msha_gnn_tpu/ops/pallas/sddmm.py``) binds one
  graph and is differentiable: ``op(h_src, h_dst)[e] = <h_src[snd_e],
  h_dst[rcv_e]>`` in CSR edge order, pads 0; its backward is the two
  SpMMs weighted by the edge gradient, as the JAX operator's is.
* :func:`rank1_logits_fn` and :func:`sddmm_cuda` give the rank-1 GAT
  logits ``leaky_relu(s_src[snd] + s_dst[rcv])`` through the operator on
  the width-2 columns ``[s_src, 1]``, ``[1, s_dst]``: one launch forward,
  two d = 2 weighted SpMMs backward.  :func:`sddmm_dot_cuda` is the
  one-shot dot product.

The weighted SpMM's gradient with respect to its edge weights is this
kernel too (:class:`msha_gnn_torch.ops.cuda.spmm.SpmmOperator`).
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING, Optional

import torch

from .rank1_gat import _edge_walk, _group
from .spmm import SpmmOperator, edge_rows, operator_for

if TYPE_CHECKING:
    from ...graph import BipartiteGraph

# Launches of csr_sddmm_f32 in this process (a plain count, reset by callers
# that measure a run).
launches = 0

# Slots a warp by default (PERF.md, the sweep of RUN_SLOTS and GROUPS at
# the linkpred shapes).
RUN = 32

_lib: Optional[ctypes.CDLL] = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("sddmm")
        lib.csr_sddmm_f32.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.csr_sddmm_f32.restype = ctypes.c_int
        lib.csr_sddmm_error_string.argtypes = [ctypes.c_int]
        lib.csr_sddmm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def csr_sddmm_plain(ptr: torch.Tensor, col: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, n_out: int) -> torch.Tensor:
    """Plain version: gather both rows of each edge, multiply, row sum."""
    e = col.numel()
    rows = edge_rows(ptr, e)
    out = a.new_zeros(n_out)
    out[:e] = (a[rows] * b[col.long()]).sum(1)
    return out


def csr_sddmm_runs_plain(ptr: torch.Tensor, col: torch.Tensor,
                         a: torch.Tensor, b: torch.Tensor, n_out: int,
                         run: int, group: int):
    """The walk of ``csr_sddmm_f32`` (``csrc/gat_bwd.cuh``, the source
    ``kNone``) in plain PyTorch, step by step as the kernel takes it
    (``rank1_gat._edge_walk``): runs of ``run`` slots of ``[0, n_out)``,
    each zeroing its pads past ``ptr[n_rows]`` and handing the edges of
    each row piece to ``32 / group`` groups, one dot an edge.

    Returns ``(out [n_out], writes [n_out])``, ``writes`` counting how
    often each slot was written (the kernel writes each once).  Slow:
    Python loops over runs and steps, for tests.
    """
    out = a.new_full((n_out,), float("nan"))
    writes = torch.zeros(n_out, dtype=torch.int64)
    for event, *at in _edge_walk(ptr, n_out, run, group, a.shape[1]):
        if event == "pads":
            out[at[0]] = 0.0
            writes[at[0]] += 1
        elif event == "step":
            row, idx = at
            out[idx] = (b[col[idx].long()] * a[row]).sum(1)
            writes.index_add_(0, idx, torch.ones_like(idx))
    return out, writes


def csr_sddmm(ptr: torch.Tensor, col: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, n_out: int, run: Optional[int] = None,
              group: Optional[int] = None) -> torch.Tensor:
    """``out[e] = <a[row(e)], b[col[e]]>`` for the CSR edges, 0 for the
    slots ``col.numel() <= e < n_out`` -> [n_out] f32.

    ``ptr`` int32 [n_rows + 1], ``col`` int32 [E] with ``E = ptr[-1]``,
    ``a`` f32 [n_rows, d], ``b`` f32 [n_cols, d], all contiguous and on one
    device.  ``run`` slots a warp (default :data:`RUN`), ``group`` lanes an
    edge (one of :data:`~.rank1_gat.GROUPS`, default
    :func:`~.rank1_gat.group_for`).  CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise.
    """
    global launches
    dev = a.device
    given = (("ptr", ptr), ("col", col), ("a", a), ("b", b))
    for name, t in given:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, a on {dev}")
    if dev.type == "cpu":
        return csr_sddmm_plain(ptr, col, a, b, n_out)
    if dev.type != "cuda":
        raise ValueError(f"csr_sddmm runs on cuda or cpu, not {dev}")
    if ptr.dtype != torch.int32 or col.dtype != torch.int32:
        raise TypeError("ptr and col must be int32")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("a and b must be float32")
    n_rows, e = ptr.numel() - 1, col.numel()
    if (ptr.dim() != 1 or col.dim() != 1 or a.dim() != 2 or b.dim() != 2
            or a.shape != (n_rows, b.shape[1]) or n_out < e):
        raise ValueError(
            f"shapes: ptr {tuple(ptr.shape)}, col {tuple(col.shape)}, a "
            f"{tuple(a.shape)}, b {tuple(b.shape)}, n_out {n_out}")
    for name, t in given:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    d = a.shape[1]
    group = _group(group, d)
    run = RUN if run is None else int(run)
    if n_rows == 0 or d == 0:
        return torch.zeros(n_out, dtype=torch.float32, device=dev)
    out = torch.empty(n_out, dtype=torch.float32, device=dev)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.csr_sddmm_f32(ptr.data_ptr(), col.data_ptr(), a.data_ptr(),
                               b.data_ptr(), out.data_ptr(), n_rows, n_out,
                               run, group, d, stream)
    if rc != 0:
        msg = lib.csr_sddmm_error_string(rc).decode()
        raise RuntimeError(f"csr_sddmm_f32 launch failed: {msg} (error {rc})")
    launches += 1
    return out


class _SddmmFn(torch.autograd.Function):
    """Per-edge dots with ``dh_src = A(g) @ h_dst`` and ``dh_dst = A(g).T @
    h_src``: the edge gradient as the SpMM's weights."""

    @staticmethod
    def forward(ctx, h_src, h_dst, op):
        ctx.op = op
        ctx.save_for_backward(h_src, h_dst)
        sp = op.spmm
        return csr_sddmm(sp.ptr, sp.col, h_src, h_dst,
                         op.graph.num_padded_edges)

    @staticmethod
    def backward(ctx, g):
        h_src, h_dst = ctx.saved_tensors
        sp = ctx.op.spmm
        g = g.contiguous()
        dh_src = dh_dst = None
        if ctx.needs_input_grad[0]:
            dh_src = sp.apply(h_dst, g, transpose=False)
        if ctx.needs_input_grad[1]:
            dh_dst = sp.apply(h_src, g, transpose=True)
        return dh_src, dh_dst, None


class SddmmOperator:
    """Differentiable per-edge dot products bound to one graph
    (``msha_gnn_tpu/ops/pallas/sddmm.py::SddmmOperator``): ``op(h_src
    [n_src, d], h_dst [n_dst, d])`` -> [E_pad] in CSR edge order, pads 0.
    The CSR/CSC arrays are those of the graph's cached
    :class:`~msha_gnn_torch.ops.cuda.spmm.SpmmOperator`."""

    def __init__(self, graph: "BipartiteGraph",
                 spmm: Optional[SpmmOperator] = None):
        self.graph = graph
        self.spmm = spmm if spmm is not None else operator_for(graph)
        self.device = self.spmm.device

    @staticmethod
    def build(graph: "BipartiteGraph",
              spmm: Optional[SpmmOperator] = None) -> "SddmmOperator":
        """The operator of ``graph``, over ``spmm``'s arrays (default: the
        graph's cached operator)."""
        return SddmmOperator(graph, spmm)

    def __call__(self, h_src: torch.Tensor, h_dst: torch.Tensor
                 ) -> torch.Tensor:
        g = self.graph
        for name, t, n in (("h_src", h_src, g.n_src), ("h_dst", h_dst,
                                                        g.n_dst)):
            if t.device != self.device:
                raise ValueError(f"{name} is on {t.device}, the operator on "
                                 f"{self.device}")
            if t.dim() != 2 or t.shape[0] != n:
                raise ValueError(f"{name} must be [{n}, d], got "
                                 f"{tuple(t.shape)}")
        if h_src.shape[1] != h_dst.shape[1]:
            raise ValueError(f"widths differ: h_src {tuple(h_src.shape)}, "
                             f"h_dst {tuple(h_dst.shape)}")
        return _SddmmFn.apply(h_src.contiguous(), h_dst.contiguous(), self)


def sddmm_dot_cuda(graph: "BipartiteGraph", h_src: torch.Tensor,
                   h_dst: torch.Tensor) -> torch.Tensor:
    """One-shot per-edge dot products (``sddmm_dot_pallas``; the graph's
    arrays are cached by :func:`~.spmm.operator_for`)."""
    return SddmmOperator.build(graph)(h_src, h_dst)


def rank1_logits_fn(op: SddmmOperator, num_edges: Optional[int] = None,
                    negative_slope: float = 0.2):
    """``logits_fn(s_src [n_src], s_dst [n_dst]) -> [E]`` over a prebuilt
    operator: ``leaky_relu(s_src[snd] + s_dst[rcv])`` in CSR edge order,
    the first ``num_edges`` slots (all ``E_pad``, pads 0, when None)."""
    def logits_fn(s_src: torch.Tensor, s_dst: torch.Tensor) -> torch.Tensor:
        out = op(torch.stack([s_src, torch.ones_like(s_src)], dim=1),
                 torch.stack([torch.ones_like(s_dst), s_dst], dim=1))
        if num_edges is not None:
            out = out[:num_edges]
        return torch.nn.functional.leaky_relu(out, negative_slope)

    return logits_fn


def sddmm_cuda(graph: "BipartiteGraph", src_vec: torch.Tensor,
               dst_vec: torch.Tensor,
               negative_slope: float = 0.2) -> torch.Tensor:
    """``sddmm(..., impl="cuda")`` (``sddmm_pallas``): the rank-1 logits
    ``leaky_relu(src_vec[s] + dst_vec[r])`` -> [E_pad], pads 0."""
    return rank1_logits_fn(SddmmOperator.build(graph),
                           negative_slope=negative_slope)(src_vec, dst_vec)
