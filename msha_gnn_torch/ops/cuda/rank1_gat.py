"""Fused rank-1 GAT through the hand-written kernels ``r1l_fwd_f32`` and
``r1l_bwd_f32`` (``msha_gnn_torch/csrc/rank1_gat.cu``).

The kernels replace ``_r1l_fwd_kernel`` and ``_r1l_bwd_kernel`` of
``msha_gnn_tpu/ops/pallas/rank1_gat.py``; the source says what they compute
and what bounds them.

* :func:`r1l_fwd` and :func:`r1l_bwd` are the kernels' wrappers: they check
  their inputs, launch on the current stream and count their launches in
  :data:`fwd_launches` and :data:`bwd_launches`.  For tensors on the CPU
  they run :func:`rank1_gat_plain` and :func:`rank1_gat_bwd_plain`, the
  plain PyTorch versions of the same functions and the kernels' oracles.
* :func:`keep_scale_plain` is the dropout keep mask, bit for bit the JAX
  package's ``_hash01``/``_keep_scale``; :func:`keep_scale` runs the
  kernels' own device function on the card, to check it against the plain
  one.
* :class:`Rank1GatOperator` binds one graph and is differentiable: its
  backward runs ``r1l_bwd_f32`` and then the edge-row reduce of
  :meth:`SpmmOperator.reduce_edges` (``csr_spmm_f32``) for ``dx``.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from .spmm import SpmmOperator, operator_for

if TYPE_CHECKING:
    from ...graph import BipartiteGraph

NEG = -1e30

# Launches of r1l_fwd_f32 / r1l_bwd_f32 in this process (plain counts, reset
# by callers that measure a run).  One r1l_bwd_f32 launch runs two grids:
# the edge kernel and the fixed-order da reduce.
fwd_launches = 0
bwd_launches = 0

_lib: Optional[ctypes.CDLL] = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("rank1_gat")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.r1l_fwd_f32.argtypes = [p] * 6 + [f] * 3 + [p] * 2 + [i] * 3 + [p]
        lib.r1l_bwd_f32.argtypes = ([p] * 9 + [f] * 3 + [p] * 4 + [i] * 3
                                    + [p])
        lib.r1l_keep_scale_f32.argtypes = [p, f, f, i, p, p]
        lib.r1l_max_warps.argtypes = [i]
        for fn in (lib.r1l_fwd_f32, lib.r1l_bwd_f32, lib.r1l_keep_scale_f32,
                   lib.r1l_max_warps):
            fn.restype = ctypes.c_int
        lib.r1l_error_string.argtypes = [i]
        lib.r1l_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.r1l_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (error {rc})")


def _scale(rate: float) -> float:
    """The kept edges' factor 1/(1-rate), rounded to float32 once."""
    return float(np.float32(1.0 / (1.0 - rate))) if rate > 0 else 1.0


# ---------------------------------------------------------------------------
# The dropout keep mask
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """``h * m mod 2**32`` for int64 ``h`` in [0, 2**32), without int64
    overflow: the multiplier is split into 16-bit halves."""
    lo = h * (m & 0xFFFF)
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def keep_scale_plain(slots: torch.Tensor, seed, rate: float) -> torch.Tensor:
    """Inverted-dropout factor of each edge slot: ``1/(1-rate)`` where kept,
    0 where dropped (float32), from the murmur3 finalizer of
    ``rank1_gat.py::_hash01`` keyed on ``(seed, slot)``.

    ``slots``: integer tensor of CSR edge indices; ``seed``: int32 tensor of
    one element (or an int).  The arithmetic is int64 masked to 32 bits,
    since torch's ``>>`` on int32 shifts arithmetically.
    """
    seed = torch.as_tensor(seed, device=slots.device).reshape(-1)[:1]
    h = _mul32(slots.to(torch.int64) & _M32, 0x9E3779B9)
    h = (h + (seed.to(torch.int64) & _M32)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    u = (h & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24))
    f32 = dict(dtype=torch.float32, device=slots.device)
    keep = u >= torch.tensor(rate, **f32)
    return torch.where(keep, torch.tensor(_scale(rate), **f32),
                       torch.tensor(0.0, **f32))


def keep_scale(n: int, seed: torch.Tensor, rate: float) -> torch.Tensor:
    """The keep scale of slots ``0..n-1``: on a CUDA ``seed`` by the
    kernels' device function (``r1l_keep_scale_f32``, a check entry that
    the main path never calls), else :func:`keep_scale_plain`."""
    if seed.device.type == "cpu":
        return keep_scale_plain(torch.arange(n), seed, rate)
    if seed.dtype != torch.int32 or seed.numel() != 1:
        raise TypeError("seed must be one int32")
    out = torch.empty(n, dtype=torch.float32, device=seed.device)
    lib = _kernel_lib()
    with torch.cuda.device(seed.device):
        stream = torch.cuda.current_stream(seed.device).cuda_stream
        rc = lib.r1l_keep_scale_f32(seed.data_ptr(), rate, _scale(rate), n,
                                    out.data_ptr(), stream)
    _raise_on(lib, rc, "r1l_keep_scale_f32")
    return out


# ---------------------------------------------------------------------------
# Plain versions (the CPU path and the kernels' oracles)
# ---------------------------------------------------------------------------

def _edge_rows(ptr: torch.Tensor, n_rows: int, n_edges: int) -> torch.Tensor:
    return torch.repeat_interleave(
        torch.arange(n_rows, device=ptr.device), (ptr[1:] - ptr[:-1]).long(),
        output_size=n_edges)


def _logits(ptr, col, c, a, x, slope, n_rows):
    rows = _edge_rows(ptr, n_rows, col.numel())
    xg = x[col.long()]
    pre = c[rows] + xg @ a
    return rows, xg, pre, torch.where(pre >= 0, pre, slope * pre)


def _keep(n_edges: int, seed, rate: float, device) -> torch.Tensor:
    if rate <= 0:
        return torch.ones(n_edges, device=device)
    return keep_scale_plain(torch.arange(n_edges, device=device), seed,
                            rate).to(device)


def rank1_gat_plain(ptr, col, c, a, x, seed, rate: float, slope: float,
                    n_rows: int):
    """Plain version of ``r1l_fwd_f32`` -> ``(out [n_rows, d], lse
    [n_rows])``: gather, ``scatter_reduce`` amax, ``index_add_``."""
    rows, xg, _, logit = _logits(ptr, col, c, a, x, slope, n_rows)
    m = torch.full((n_rows,), NEG, dtype=x.dtype, device=x.device)
    m = m.scatter_reduce(0, rows, logit, "amax", include_self=True)
    p = torch.exp(logit - m[rows])
    s = x.new_zeros(n_rows).index_add_(0, rows, p)
    w = p * _keep(col.numel(), seed, rate, x.device)
    agg = x.new_zeros((n_rows, x.shape[1])).index_add_(0, rows,
                                                      w[:, None] * xg)
    live = s > 0
    out = torch.where(live[:, None], agg / torch.where(live, s, 1.0)[:, None],
                      0.0)
    lse = torch.where(live, m + torch.log(torch.where(live, s, 1.0)), NEG)
    return out, lse


def rank1_gat_bwd_plain(ptr, col, c, a, x, gout, out, lse, seed, rate: float,
                        slope: float, n_rows: int):
    """Plain version of ``r1l_bwd_f32`` -> ``(z [E, d] in CSR order, dc
    [n_rows], da [d])``."""
    rows, xg, pre, logit = _logits(ptr, col, c, a, x, slope, n_rows)
    lse_e = lse[rows]
    live = lse_e > NEG / 2
    att = torch.where(live, torch.exp(torch.where(live, logit - lse_e, 0.0)),
                      0.0)
    q = att * _keep(col.numel(), seed, rate, x.device)
    g = gout[rows]
    dl = q * (g * xg).sum(1) - att * (gout * out).sum(1)[rows]
    dpre = torch.where(pre >= 0, dl, slope * dl)
    z = q[:, None] * g + dpre[:, None] * a
    dc = x.new_zeros(n_rows).index_add_(0, rows, dpre)
    return z, dc, (dpre[:, None] * xg).sum(0)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(dev, rate, **tensors):
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if dev.type != "cuda":
        raise ValueError(f"the rank-1 GAT kernels run on cuda or cpu, not {dev}")
    for name, t in tensors.items():
        want = torch.int32 if name in ("ptr", "col", "seed") else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"rate must be in [0, 1), got {rate}")


def _warps(d: int) -> int:
    """Warps per block: the most (up to 8) whose shared memory fits."""
    w = _kernel_lib().r1l_max_warps(d)
    if w < 1:
        raise ValueError(f"feature width {d} does not fit the kernels' "
                         "shared memory")
    return w


def _shapes(ptr, col, c, a, x, n_rows):
    d = x.shape[1] if x.dim() == 2 else -1
    if (x.dim() != 2 or ptr.shape != (n_rows + 1,) or col.dim() != 1
            or c.shape != (n_rows,) or a.shape != (d,)):
        raise ValueError(
            f"shapes: ptr {tuple(ptr.shape)} for {n_rows} rows, col "
            f"{tuple(col.shape)}, c {tuple(c.shape)}, a {tuple(a.shape)}, "
            f"x {tuple(x.shape)}")
    return d


def r1l_fwd(ptr, col, c, a, x, seed, rate: float, slope: float, n_rows: int):
    """Forward -> ``(out [n_rows, d], lse [n_rows])`` float32.

    ``ptr`` int32 [n_rows + 1], ``col`` int32 [E] (CSR, slot = index),
    ``c`` f32 [n_rows], ``a`` f32 [d], ``x`` f32 [n_cols, d], ``seed``
    int32 [1] (read when ``rate > 0``).  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise.
    """
    global fwd_launches
    if x.device.type == "cpu":
        return rank1_gat_plain(ptr, col, c, a, x, seed, rate, slope, n_rows)
    _check(x.device, rate, ptr=ptr, col=col, c=c, a=a, x=x, seed=seed)
    d = _shapes(ptr, col, c, a, x, n_rows)
    out = torch.empty((n_rows, d), dtype=torch.float32, device=x.device)
    lse = torch.empty(n_rows, dtype=torch.float32, device=x.device)
    if n_rows == 0 or d == 0:
        return out, lse
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.r1l_fwd_f32(
            ptr.data_ptr(), col.data_ptr(), c.data_ptr(), a.data_ptr(),
            x.data_ptr(), seed.data_ptr(), rate, _scale(rate), slope,
            out.data_ptr(), lse.data_ptr(), n_rows, d, _warps(d), stream)
    _raise_on(lib, rc, "r1l_fwd_f32")
    fwd_launches += 1
    return out, lse


def r1l_bwd(ptr, col, c, a, x, gout, out, lse, seed, rate: float,
            slope: float, n_rows: int):
    """Recompute backward -> ``(z [E, d], dc [n_rows], da [d])`` float32;
    ``gout``, ``out`` [n_rows, d] and ``lse`` [n_rows] as the forward gave
    them.  CPU tensors take the plain version."""
    global bwd_launches
    if x.device.type == "cpu":
        return rank1_gat_bwd_plain(ptr, col, c, a, x, gout, out, lse, seed,
                                   rate, slope, n_rows)
    _check(x.device, rate, ptr=ptr, col=col, c=c, a=a, x=x, gout=gout,
           out=out, lse=lse, seed=seed)
    d = _shapes(ptr, col, c, a, x, n_rows)
    if gout.shape != (n_rows, d) or out.shape != (n_rows, d) or \
            lse.shape != (n_rows,):
        raise ValueError(f"gout {tuple(gout.shape)}, out {tuple(out.shape)} "
                         f"and lse {tuple(lse.shape)} must be [{n_rows}, "
                         f"{d}] and [{n_rows}]")
    dev = x.device
    z = torch.empty((col.numel(), d), dtype=torch.float32, device=dev)
    dc = torch.empty(n_rows, dtype=torch.float32, device=dev)
    da = torch.empty(d, dtype=torch.float32, device=dev)
    if n_rows == 0 or d == 0:
        return z, dc, da
    da_part = torch.empty((n_rows, d), dtype=torch.float32, device=dev)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.r1l_bwd_f32(
            ptr.data_ptr(), col.data_ptr(), c.data_ptr(), a.data_ptr(),
            x.data_ptr(), gout.data_ptr(), out.data_ptr(), lse.data_ptr(),
            seed.data_ptr(), rate, _scale(rate), slope, z.data_ptr(),
            dc.data_ptr(), da_part.data_ptr(), da.data_ptr(), n_rows, d,
            _warps(d), stream)
    _raise_on(lib, rc, "r1l_bwd_f32")
    bwd_launches += 1
    return z, dc, da


# ---------------------------------------------------------------------------
# The operator
# ---------------------------------------------------------------------------

class _Rank1Lin(torch.autograd.Function):
    """``out = rank1_gat(c, a, x)`` with the recompute backward."""

    @staticmethod
    def forward(ctx, c, a, x, seed, op, rate):
        g = op.graph
        out, lse = r1l_fwd(op.ptr, op.col, c, a, x, seed, rate, op.slope,
                           g.n_src)
        ctx.save_for_backward(c, a, x, out, lse, seed)
        ctx.op, ctx.rate = op, rate
        return out

    @staticmethod
    def backward(ctx, gout):
        c, a, x, out, lse, seed = ctx.saved_tensors
        op = ctx.op
        z, dc, da = r1l_bwd(op.ptr, op.col, c, a, x, gout.contiguous(), out,
                            lse, seed, ctx.rate, op.slope, op.graph.n_src)
        return dc, da, op.spmm.reduce_edges(z), None, None, None


class Rank1GatOperator:
    """Differentiable fused rank-1 GAT layer bound to one graph
    (``rank1_gat.py::Rank1GatOperator`` with ``dst_linear=True``).

    ``op(c, a, x)`` with ``c`` [n_src], ``a`` [d], ``x`` [n_dst, d]::

        t = x @ a                                    # in the kernel
        att = softmax_per_src_row(leaky_relu(c[snd] + t[rcv]))
        out[i] = sum_e att_e * x[rcv_e]              # [n_src, d]

    and its gradient ``(dc, da, dx)``.  ``op.drop(c, a, x, seed)`` applies
    inverted attention dropout at ``dropout_rate`` after the normalisation,
    with the keep mask hashed from ``(seed, edge slot)``.  Rows with no
    edges give zeros.

    Only ``dst_linear=True`` is ported: the generic ``(c, t, x)`` mode runs
    TPU kernels that have no counterpart yet, so building without it raises
    (and ``drop`` can never run on a generic operator, the hazard of
    ``rank1_gat.py:861-891``).
    """

    def __init__(self, graph: "BipartiteGraph", *,
                 negative_slope: float = 0.2, dst_linear: bool = False,
                 dropout_rate: float = 0.0):
        if not dst_linear:
            raise NotImplementedError(
                "Rank1GatOperator(dst_linear=False) needs _r1_fwd_kernel and "
                "_r1_bwd_kernel (msha_gnn_tpu/ops/pallas/rank1_gat.py:94, "
                ":160), which are not ported yet (ROADMAP queue 2)")
        r = float(dropout_rate)
        if not 0.0 <= r < 1.0:
            raise ValueError(f"dropout_rate must be in [0, 1), got {r}")
        self.graph = graph
        self.spmm: SpmmOperator = operator_for(graph)
        self.device = self.spmm.device
        self.ptr, self.col = self.spmm.ptr, self.spmm.col
        self.slope = float(negative_slope)
        self.dst_linear = dst_linear
        self.dropout_rate = r

    def _apply(self, c, a, x, seed, rate):
        g = self.graph
        if x.device != self.device:
            raise ValueError(f"x is on {x.device}, the operator on "
                             f"{self.device}")
        if c.shape != (g.n_src,) or x.dim() != 2 or x.shape[0] != g.n_dst \
                or a.shape != (x.shape[1],):
            raise ValueError(f"c {tuple(c.shape)}, a {tuple(a.shape)}, x "
                             f"{tuple(x.shape)} for a {g.n_src} x {g.n_dst} "
                             "graph")
        return _Rank1Lin.apply(c.contiguous(), a.contiguous(),
                               x.contiguous(), seed, self, rate)

    def __call__(self, c: torch.Tensor, a: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
        return self._apply(c, a, x, self.ptr.new_zeros(1), 0.0)

    def drop(self, c: torch.Tensor, a: torch.Tensor, x: torch.Tensor,
             seed: torch.Tensor) -> torch.Tensor:
        """Forward with in-kernel attention dropout at ``dropout_rate``.
        ``seed``: int32 [1] on the operator's device.  At rate 0 this
        equals ``__call__`` exactly."""
        if not self.dst_linear:
            raise ValueError("drop() needs a dst_linear operator")
        seed = seed.reshape(1).to(device=self.device, dtype=torch.int32)
        return self._apply(c, a, x, seed, self.dropout_rate)
