"""Softmax of per-edge logits over CSR rows through the hand-written
kernels ``seg_softmax_fwd_f32`` and ``seg_softmax_bwd_f32``
(``msha_gnn_torch/csrc/softmax.cu``).

The kernels replace ``_stats_kernel``, ``_expand_kernel`` and
``_rowsum_kernel`` of ``msha_gnn_tpu/ops/pallas/softmax.py``; the source
says what they compute and what bounds them (bytes).

* :func:`seg_softmax_fwd` and :func:`seg_softmax_bwd` are the kernels'
  wrappers: they check their inputs, launch on the current stream and
  count their launches in :data:`fwd_launches` and :data:`bwd_launches`.
  For tensors on the CPU they run :func:`seg_softmax_fwd_plain` and
  :func:`seg_softmax_bwd_plain`, the plain PyTorch versions of the same
  functions and the kernels' oracles.
* :class:`SegmentSoftmaxOperator` (``softmax.py::SegmentSoftmaxOperator``)
  binds one edge sort and a static per-edge mask and is differentiable.
  ``broadcast_rows`` of the JAX operator serves only
  ``training/scale.py`` and is not ported yet.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING, Optional

import torch

from ... import resolve_device
from .spmm import cached_for, edge_rows, warps_for

if TYPE_CHECKING:
    from ...graph import BipartiteGraph

NEG = -1e30

# Launches of seg_softmax_fwd_f32 / seg_softmax_bwd_f32 in this process
# (plain counts, reset by callers that measure a run).
fwd_launches = 0
bwd_launches = 0

_lib: Optional[ctypes.CDLL] = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("softmax")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.seg_softmax_fwd_f32.argtypes = [p] * 5 + [i] * 4 + [p]
        lib.seg_softmax_bwd_f32.argtypes = [p] * 4 + [i] * 4 + [p]
        for fn in (lib.seg_softmax_fwd_f32, lib.seg_softmax_bwd_f32):
            fn.restype = ctypes.c_int
        lib.seg_softmax_error_string.argtypes = [i]
        lib.seg_softmax_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def seg_softmax_fwd_plain(ptr: torch.Tensor, logits: torch.Tensor,
                          mask: Optional[torch.Tensor], n_edges: int):
    """Plain version of ``seg_softmax_fwd_f32`` -> ``(att [n_out], lse
    [n_rows])``: ``scatter_reduce`` amax, ``index_add_``, gathers."""
    n_rows = ptr.numel() - 1
    rows = edge_rows(ptr, n_edges)
    e = n_edges
    l = logits[:e]
    keep = (torch.ones_like(l, dtype=torch.bool) if mask is None
            else mask[:e].bool())
    l = torch.where(keep, l, NEG)
    m = torch.full((n_rows,), NEG, dtype=l.dtype, device=l.device)
    m = m.scatter_reduce(0, rows, l, "amax", include_self=True)
    p = torch.where(keep, torch.exp(l - m[rows]), 0.0)
    s = l.new_zeros(n_rows).index_add_(0, rows, p)
    lse = m + torch.log(torch.clamp(s, min=1e-30))
    att = logits.new_zeros(logits.shape[0])
    att[:e] = torch.where(keep, torch.exp(l - lse[rows]), 0.0)
    return att, lse


def seg_softmax_bwd_plain(ptr: torch.Tensor, att: torch.Tensor,
                          g: torch.Tensor, n_edges: int) -> torch.Tensor:
    """Plain version of ``seg_softmax_bwd_f32`` -> ``dl [n_out]``:
    ``att*g - att*rowsum(att*g)[row]`` by ``index_add_`` and a gather."""
    rows = edge_rows(ptr, n_edges)
    e = n_edges
    t = att[:e] * g[:e]
    rs = att.new_zeros(ptr.numel() - 1).index_add_(0, rows, t)
    dl = att.new_zeros(att.shape[0])
    dl[:e] = t - att[:e] * rs[rows]
    return dl


def _check(name: str, dev: torch.device, **tensors) -> None:
    for key, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{key} is on {t.device}, the logits on {dev}")
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    want = {"ptr": torch.int32, "mask": torch.bool}
    for key, t in tensors.items():
        if t.dtype != want.get(key, torch.float32):
            raise TypeError(f"{key} must be {want.get(key, torch.float32)}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{key} must be contiguous")
        if t.dim() != 1:
            raise ValueError(f"{key} must be 1-D, got {tuple(t.shape)}")


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.seg_softmax_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (error {rc})")


def seg_softmax_fwd(ptr: torch.Tensor, logits: torch.Tensor,
                    mask: Optional[torch.Tensor], n_edges: int,
                    n_warps: int):
    """Row softmax of ``logits`` [n_out] (CSR order; ``n_edges = ptr[-1]
    <= n_out``) -> ``(att [n_out], lse [n_rows])`` float32; ``mask`` bool
    [n_out] or None.  Masked edges and pad slots get 0.  ``n_warps`` per
    block (1..8, see :func:`~msha_gnn_torch.ops.cuda.spmm.warps_for`).
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    global fwd_launches
    if logits.device.type == "cpu":
        return seg_softmax_fwd_plain(ptr, logits, mask, n_edges)
    given = dict(ptr=ptr, logits=logits)
    if mask is not None:
        given["mask"] = mask
        if mask.shape != logits.shape:
            raise ValueError(f"mask {tuple(mask.shape)} and logits "
                             f"{tuple(logits.shape)} differ")
    _check("seg_softmax_fwd_f32", logits.device, **given)
    n_rows, n_out = ptr.numel() - 1, logits.numel()
    att = torch.empty(n_out, dtype=torch.float32, device=logits.device)
    lse = torch.empty(n_rows, dtype=torch.float32, device=logits.device)
    if n_rows == 0:
        return att.zero_(), lse
    lib = _kernel_lib()
    dev = logits.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.seg_softmax_fwd_f32(
            ptr.data_ptr(), logits.data_ptr(),
            None if mask is None else mask.data_ptr(), att.data_ptr(),
            lse.data_ptr(), n_rows, n_edges, n_out, n_warps, stream)
    _raise_on(lib, rc, "seg_softmax_fwd_f32")
    fwd_launches += 1
    return att, lse


def seg_softmax_bwd(ptr: torch.Tensor, att: torch.Tensor, g: torch.Tensor,
                    n_edges: int, n_warps: int) -> torch.Tensor:
    """The softmax's vector-Jacobian product ``dl [n_out]`` for ``att`` as
    the forward gave it and the cotangent ``g`` [n_out]; pad slots get 0.
    CPU tensors take the plain version."""
    global bwd_launches
    if att.device.type == "cpu":
        return seg_softmax_bwd_plain(ptr, att, g, n_edges)
    _check("seg_softmax_bwd_f32", att.device, ptr=ptr, att=att, g=g)
    if g.shape != att.shape:
        raise ValueError(f"g {tuple(g.shape)} and att {tuple(att.shape)} "
                         "differ")
    n_rows, n_out = ptr.numel() - 1, att.numel()
    dl = torch.empty(n_out, dtype=torch.float32, device=att.device)
    if n_rows == 0:
        return dl.zero_()
    lib = _kernel_lib()
    dev = att.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.seg_softmax_bwd_f32(ptr.data_ptr(), att.data_ptr(),
                                     g.data_ptr(), dl.data_ptr(), n_rows,
                                     n_edges, n_out, n_warps, stream)
    _raise_on(lib, rc, "seg_softmax_bwd_f32")
    bwd_launches += 1
    return dl


# ---------------------------------------------------------------------------
# The operator
# ---------------------------------------------------------------------------

class _SoftmaxFn(torch.autograd.Function):
    """``att = softmax_per_row(l)`` with ``dl = att*g - att*rowsum(att*g)``,
    as ``softmax.py::SegmentSoftmaxOperator``'s VJP."""

    @staticmethod
    def forward(ctx, logits, op):
        att, _ = seg_softmax_fwd(op.ptr, logits, op.mask, op.num_edges,
                                 op.warps)
        ctx.op = op
        ctx.save_for_backward(att)
        return att

    @staticmethod
    def backward(ctx, g):
        (att,) = ctx.saved_tensors
        op = ctx.op
        return seg_softmax_bwd(op.ptr, att, g.contiguous(), op.num_edges,
                               op.warps), None


class SegmentSoftmaxOperator:
    """Differentiable softmax of per-edge logits over each CSR row, bound
    to one edge sort (``softmax.py::SegmentSoftmaxOperator``).

    ``senders`` [E_pad] (CSR order; slots past ``row_ptr[-1]`` are pads),
    ``row_ptr`` [n_rows + 1], ``mask``: a static per-edge validity [E_pad]
    or None.  Masked edges get attention 0 and take no part in their row's
    denominator, so a fully masked row gives zeros; pad slots always get 0.
    ``op(logits [E_pad])`` -> ``att [E_pad]``.
    """

    def __init__(self, senders, row_ptr, n_rows: int, mask=None,
                 device="cuda"):
        dev = resolve_device(device)
        self.device = dev
        self.ptr = torch.as_tensor(row_ptr).to(dev, torch.int32).contiguous()
        if self.ptr.shape != (n_rows + 1,):
            raise ValueError(f"row_ptr {tuple(self.ptr.shape)} for {n_rows} "
                             "rows")
        self.num_padded_edges = int(torch.as_tensor(senders).shape[0])
        self.num_edges = int(self.ptr[-1])
        if self.num_edges > self.num_padded_edges:
            raise ValueError(f"row_ptr ends at {self.num_edges}, past the "
                             f"{self.num_padded_edges} edge slots")
        self.mask = None
        if mask is not None:
            self.mask = torch.as_tensor(mask).to(dev, torch.bool).contiguous()
            if self.mask.shape != (self.num_padded_edges,):
                raise ValueError(f"mask {tuple(self.mask.shape)} for "
                                 f"{self.num_padded_edges} edge slots")
        row_len = (self.ptr[1:] - self.ptr[:-1]).cpu()
        self.warps = warps_for(self.num_edges, n_rows,
                               int(row_len.max()) if n_rows else 0)

    @staticmethod
    def build(graph: "BipartiteGraph") -> "SegmentSoftmaxOperator":
        """The operator of ``graph``'s rows (``per="src"``).  The JAX build
        masks ``senders < n_src``; here that mask needs no bytes: it is
        False only on the pad slots past ``row_ptr[-1]``, which the kernels
        never visit and write as 0."""
        return SegmentSoftmaxOperator(graph.senders, graph.row_ptr,
                                      graph.n_src, device=graph.device)

    def __call__(self, logits: torch.Tensor) -> torch.Tensor:
        if logits.device != self.device:
            raise ValueError(f"logits are on {logits.device}, the operator "
                             f"on {self.device}")
        if logits.shape != (self.num_padded_edges,):
            raise ValueError(f"logits must be [{self.num_padded_edges}], got "
                             f"{tuple(logits.shape)}")
        return _SoftmaxFn.apply(logits.contiguous(), self)


def softmax_operator_for(graph: "BipartiteGraph") -> SegmentSoftmaxOperator:
    """The cached :class:`SegmentSoftmaxOperator` of ``graph``."""
    return cached_for(graph, SegmentSoftmaxOperator.build)
