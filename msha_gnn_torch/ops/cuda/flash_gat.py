"""Flash-GAT through the hand-written kernels ``flash_fwd_f32`` and
``flash_bwd_f32`` (``msha_gnn_torch/csrc/flash_gat.cu``; the forward is
the edge-run walk of ``csrc/gat_fwd.cuh`` with the logits read, which
``r1l_fwd_f32`` and ``r1_fwd_f32`` share; the backward is the per-edge walk
of ``csrc/gat_bwd.cuh``, which the same source's ``r1_bwd_f32``, the
generic rank-1 GAT's backward, wrapped in
:mod:`msha_gnn_torch.ops.cuda.rank1_gat`, and ``csr_sddmm_f32`` share).

The kernels replace ``_flash_kernel`` and ``_flash_bwd_kernel`` of
``msha_gnn_tpu/ops/pallas/flash_gat.py``; the source says what they
compute and what bounds them (bytes).

* :func:`flash_fwd` and :func:`flash_bwd` are the kernels' wrappers: they
  check their inputs, launch on the current stream and count their launches
  in :data:`fwd_launches` and :data:`bwd_launches`.  For tensors on the CPU
  they run :func:`flash_gat_plain` and :func:`flash_gat_bwd_plain`, the
  plain PyTorch versions of the same functions and the kernels' oracles.
  :func:`flash_gat_runs_plain` and :func:`flash_gat_bwd_runs_plain` mirror
  the kernels' edge-run walks step by step, for tests, and
  :func:`rank1_gat_generic_bwd_runs_plain` the walk of ``r1_bwd_f32``.
* :class:`FlashGatOperator` binds one graph and is differentiable: softmax
  of given per-edge logits over each row, the hashed attention dropout and
  the aggregation in one kernel, with a recompute backward.  Its ``dx`` is
  the transposed ``csr_spmm_f32`` of ``gout`` weighted by the backward's
  ``q``, where the TPU kernel wrote ``z = q gout`` [E, d] and reduced it.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING, Optional

import torch

from .rank1_gat import (NEG, _edge_walk, _fwd_runs_plain, _group, _keep,
                        _scale)
from .spmm import (SpmmOperator, edge_rows, n_runs, operator_for, warp_run,
                   widen)

if TYPE_CHECKING:
    from ...graph import BipartiteGraph

# Slots a warp of flash_bwd_f32 by default.  Nothing of it sums over a
# row, so a shorter run costs no fix-up: 32 was the fastest of RUN_SLOTS on
# the card at the linkpred shapes (PERF.md, the sweep of RUN_SLOTS and
# GROUPS).
BWD_RUN = 32

# Warps a block in every launch of this library: no kernel of it keeps
# shared memory, so the block's size limits nothing.
WARPS = 8

# Launches of flash_fwd_f32 / flash_bwd_f32 in this process (plain counts,
# reset by callers that measure a run).  A flash_fwd_f32 launch runs two
# grids: the edge runs, then the merge of the rows that cross runs.
fwd_launches = 0
bwd_launches = 0

_lib: Optional[ctypes.CDLL] = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("flash_gat")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_fwd_f32.argtypes = [p] * 5 + [f] * 2 + [p] * 3 + [i] * 6 + [p]
        lib.flash_bwd_f32.argtypes = [p] * 8 + [f] * 2 + [p] * 2 + [i] * 6 + [p]
        # the generic rank-1 GAT's backward (wrapped in rank1_gat.py)
        lib.r1_bwd_f32.argtypes = [p] * 8 + [f] + [p] * 4 + [i] * 6 + [p]
        lib.r1_bwd_bf16.argtypes = lib.r1_bwd_f32.argtypes
        for fn in (lib.flash_fwd_f32, lib.flash_bwd_f32, lib.r1_bwd_f32,
                   lib.r1_bwd_bf16):
            fn.restype = ctypes.c_int
        lib.flash_error_string.argtypes = [i]
        lib.flash_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.flash_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (error {rc})")


# ---------------------------------------------------------------------------
# Plain versions (the CPU path and the kernels' oracles)
# ---------------------------------------------------------------------------

def flash_gat_plain(ptr, col, logits, x, seed, rate: float, n_rows: int):
    """Plain version of ``flash_fwd_f32`` -> ``(out [n_rows, d], lse
    [n_rows])``: gather, ``scatter_reduce`` amax, ``index_add_``.  Only the
    first ``E = col.numel()`` logits are read."""
    e = col.numel()
    rows = edge_rows(ptr, e)
    logit = logits[:e]
    m = torch.full((n_rows,), NEG, dtype=x.dtype, device=x.device)
    m = m.scatter_reduce(0, rows, logit, "amax", include_self=True)
    p = torch.exp(logit - m[rows])
    s = x.new_zeros(n_rows).index_add_(0, rows, p)
    w = p * _keep(e, seed, rate, x.device)
    agg = x.new_zeros((n_rows, x.shape[1])).index_add_(
        0, rows, w[:, None] * x[col.long()])
    live = s > 0
    out = torch.where(live[:, None], agg / torch.where(live, s, 1.0)[:, None],
                      0.0)
    lse = torch.where(live, m + torch.log(torch.where(live, s, 1.0)), NEG)
    return out, lse


def flash_gat_bwd_plain(ptr, col, logits, x, gout, out, lse, seed,
                        rate: float, n_rows: int):
    """Plain version of ``flash_bwd_f32`` -> ``(dl [n_out], q [n_out])``
    for ``logits`` [n_out], pads (past ``E = col.numel()``) 0."""
    e = col.numel()
    rows = edge_rows(ptr, e)
    lse_e = lse[rows]
    live = lse_e > NEG / 2
    att = torch.where(live, torch.exp(torch.where(live, logits[:e] - lse_e,
                                                  0.0)), 0.0)
    q = att * _keep(e, seed, rate, x.device)
    gx = (gout[rows] * x[col.long()]).sum(1)
    dl = logits.new_zeros(logits.shape[0])
    dl[:e] = q * gx - att * (gout * out).sum(1)[rows]
    q_out = logits.new_zeros(logits.shape[0])
    q_out[:e] = q
    return dl, q_out


def flash_gat_runs_plain(ptr, col, logits, x, seed, rate: float,
                         n_rows: int, run: int, group: int):
    """The walk of ``flash_fwd_f32`` (the logit source ``kRead``: the
    logits as given) in plain PyTorch, step by step as the kernel takes it
    (``rank1_gat._fwd_runs_plain``).  ``col`` and ``logits`` may run past
    ``ptr[n_rows]``.  Returns ``(out [n_rows, d], lse [n_rows], writes
    [n_rows])``, ``writes`` counting how often each row was written."""
    n_edges = int(ptr[n_rows])
    return _fwd_runs_plain(ptr, logits[:n_edges],
                           _keep(n_edges, seed, rate, x.device),
                           x[col[:n_edges].long()], n_rows, run, group)


def flash_gat_bwd_runs_plain(ptr, col, logits, x, gout, out, lse, seed,
                             rate: float, n_rows: int, run: int, group: int):
    """The walk of ``flash_bwd_f32`` (``csrc/gat_bwd.cuh``, the source
    ``kRead``) in plain PyTorch, step by step as the kernel takes it
    (``rank1_gat._edge_walk``): runs of ``run`` consecutive slots of
    ``[0, n_out)``, each zeroing its pad slots past ``ptr[n_rows]`` and
    walking its row pieces, with the row's ``<gout[r], out[r]>`` and
    ``lse[r]`` and the edges handed to ``32 / group`` groups, a step at a
    time.

    Returns ``(dl [n_out], q [n_out], writes [n_out])``, ``writes``
    counting how often each slot was written (the kernel writes each
    once).  Slow: Python loops over runs and steps, for tests.
    """
    n_edges, n_out = int(ptr[n_rows]), logits.shape[0]
    keep = _keep(n_edges, seed, rate, x.device)
    dl = logits.new_full((n_out,), float("nan"))
    q = logits.new_full((n_out,), float("nan"))
    writes = torch.zeros(n_out, dtype=torch.int64)
    for event, *at in _edge_walk(ptr, n_out, run, group, x.shape[1]):
        if event == "pads":
            dl[at[0]], q[at[0]] = 0.0, 0.0
            writes[at[0]] += 1
        elif event == "step":
            row, idx = at
            lse_row = lse[row]
            d_row = (gout[row] * out[row]).sum()
            gx = (x[col[idx].long()] * gout[row]).sum(1)
            att = (torch.exp(logits[idx] - lse_row) if lse_row > NEG / 2
                   else logits.new_zeros(idx.numel()))
            qe = att * keep[idx]
            dl[idx], q[idx] = qe * gx - att * d_row, qe
            writes.index_add_(0, idx, torch.ones_like(idx))
    return dl, q, writes


def rank1_gat_generic_bwd_runs_plain(ptr, col, c, t, x, gout, out, lse,
                                     slope: float, n_rows: int, run: int,
                                     group: int):
    """The walk of ``r1_bwd_f32`` (``csrc/gat_bwd.cuh``, the source
    ``kRank1``) in plain PyTorch, step by step as the kernel takes it:
    :func:`flash_gat_bwd_runs_plain` on the logits ``leaky(c[r] + t[j])``,
    ``dpre`` from its ``dl``, and ``dc`` summed by row piece
    (``rank1_gat._edge_walk``): a row inside a run is written, a crossing
    row leaves head and tail pieces that the fix-up adds in run order, and
    the empty rows are zeroed by the runs that own them.  ``col`` [n_out]
    may run past ``ptr[n_rows]``.

    Returns ``(att [n_out], dpre [n_out], dc [n_rows], writes [n_out],
    dc_writes [n_rows])``, the ``writes`` counting how often each slot and
    each row of ``dc`` was written (the kernel writes each once).  A
    bfloat16 ``x`` is widened first, as ``r1_bwd_bf16`` widens its rows.
    Slow: Python loops over runs and steps, for tests.
    """
    x = widen(x)
    n_edges, n_out = int(ptr[n_rows]), col.numel()
    pre = x.new_zeros(n_out)
    pre[:n_edges] = (c[edge_rows(ptr, n_edges)]
                     + t[col[:n_edges].long()])
    logits = torch.where(pre >= 0, pre, slope * pre)
    dl, att, writes = flash_gat_bwd_runs_plain(
        ptr, col, logits, x, gout, out, lse, None, 0.0, n_rows, run, group)
    dpre = torch.where(pre >= 0, dl, slope * dl)
    dc = x.new_full((n_rows,), float("nan"))
    dc_writes = torch.zeros(n_rows, dtype=torch.int64)
    n = n_runs(n_out, run)
    head, tail, cross = [None] * n, [None] * n, [-1] * n
    piece = x.new_zeros(())
    for event, *at in _edge_walk(ptr, n_out, run, group, x.shape[1]):
        if event == "empty":
            dc[at[0]] = 0.0
            dc_writes[at[0]] += 1
        elif event == "step":
            piece = piece + dpre[at[1]].sum()
        elif event == "piece":
            k, row, target = at
            if target == "out":
                dc[row] = piece
                dc_writes[row] += 1
            elif target == "head":
                head[k] = piece
            else:
                tail[k], cross[k] = piece, row
            piece = x.new_zeros(())
    ends = [int(v) for v in ptr[1:].tolist()]
    for k, r in enumerate(cross):
        if r < 0:
            continue
        v = tail[k]
        for j in range(k + 1, (ends[r] - 1) // run + 1):
            v = v + head[j]
        dc[r] = v
        dc_writes[r] += 1
    return att, dpre, dc, writes, dc_writes


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(dev, rate, **tensors):
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if dev.type != "cuda":
        raise ValueError(f"the flash-GAT kernels run on cuda or cpu, not {dev}")
    for name, t in tensors.items():
        want = torch.int32 if name in ("ptr", "col", "seed") else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"rate must be in [0, 1), got {rate}")


def _shapes(ptr, col, logits, x, n_rows):
    d = x.shape[1] if x.dim() == 2 else -1
    if (x.dim() != 2 or ptr.shape != (n_rows + 1,) or col.dim() != 1
            or logits.dim() != 1 or logits.shape[0] < col.shape[0]):
        raise ValueError(
            f"shapes: ptr {tuple(ptr.shape)} for {n_rows} rows, col "
            f"{tuple(col.shape)}, logits {tuple(logits.shape)}, x "
            f"{tuple(x.shape)}")
    return d


def flash_fwd(ptr, col, logits, x, seed, rate: float, n_rows: int,
              run: Optional[int] = None, group: Optional[int] = None):
    """Forward -> ``(out [n_rows, d], lse [n_rows])`` float32.

    ``ptr`` int32 [n_rows + 1], ``col`` int32 [E] (CSR, slot = index; it
    may run past ``ptr[n_rows]``: the kernel reads the edge count from
    ``ptr`` on the card), ``logits`` f32 [>= E] in CSR order, ``x`` f32
    [n_cols, d], ``seed`` int32 [1] (read when ``rate > 0``).  ``run``
    slots a warp (default :func:`~.spmm.warp_run`), ``group`` lanes an edge
    (one of :data:`~.rank1_gat.GROUPS`, default
    :func:`~.rank1_gat.group_for`).  CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise.
    """
    global fwd_launches
    if x.device.type == "cpu":
        return flash_gat_plain(ptr, col, logits, x, seed, rate, n_rows)
    _check(x.device, rate, ptr=ptr, col=col, logits=logits, x=x, seed=seed)
    d = _shapes(ptr, col, logits, x, n_rows)
    group = _group(group, d)
    out = torch.empty((n_rows, d), dtype=torch.float32, device=x.device)
    lse = torch.empty(n_rows, dtype=torch.float32, device=x.device)
    if n_rows == 0:
        return out, lse
    e = col.numel()  # slots: a bound on the edges
    run = warp_run(e) if run is None else int(run)
    ws = torch.empty(n_runs(e, run) * (2 * d + 5), dtype=torch.float32,
                     device=x.device)
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.flash_fwd_f32(
            ptr.data_ptr(), col.data_ptr(), logits.data_ptr(), x.data_ptr(),
            seed.data_ptr(), rate, _scale(rate), out.data_ptr(),
            lse.data_ptr(), ws.data_ptr(), n_rows, e, run, group, d, WARPS,
            stream)
    _raise_on(lib, rc, "flash_fwd_f32")
    fwd_launches += 1
    return out, lse


def flash_bwd(ptr, col, logits, x, gout, out, lse, seed, rate: float,
              n_rows: int, run: Optional[int] = None,
              group: Optional[int] = None):
    """Recompute backward -> ``(dl [n_out], q [n_out])`` float32 for
    ``logits`` [n_out], pads 0; ``gout``, ``out`` [n_rows, d] and ``lse``
    [n_rows] as the forward gave them.  ``run`` slots a warp (default
    :data:`BWD_RUN`), ``group`` lanes an edge (one of
    :data:`~.rank1_gat.GROUPS`, default :func:`~.rank1_gat.group_for`).
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    global bwd_launches
    if x.device.type == "cpu":
        return flash_gat_bwd_plain(ptr, col, logits, x, gout, out, lse, seed,
                                   rate, n_rows)
    _check(x.device, rate, ptr=ptr, col=col, logits=logits, x=x, gout=gout,
           out=out, lse=lse, seed=seed)
    d = _shapes(ptr, col, logits, x, n_rows)
    if gout.shape != (n_rows, d) or out.shape != (n_rows, d) or \
            lse.shape != (n_rows,):
        raise ValueError(f"gout {tuple(gout.shape)}, out {tuple(out.shape)} "
                         f"and lse {tuple(lse.shape)} must be [{n_rows}, "
                         f"{d}] and [{n_rows}]")
    dev, n_out = x.device, logits.shape[0]
    group = _group(group, d)
    dl = torch.empty(n_out, dtype=torch.float32, device=dev)
    q = torch.empty(n_out, dtype=torch.float32, device=dev)
    if n_rows == 0:
        return dl.zero_(), q.zero_()
    run = BWD_RUN if run is None else int(run)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_bwd_f32(
            ptr.data_ptr(), col.data_ptr(), logits.data_ptr(), x.data_ptr(),
            gout.data_ptr(), out.data_ptr(), lse.data_ptr(), seed.data_ptr(),
            rate, _scale(rate), dl.data_ptr(), q.data_ptr(), n_rows, n_out,
            run, group, d, WARPS, stream)
    _raise_on(lib, rc, "flash_bwd_f32")
    bwd_launches += 1
    return dl, q


# ---------------------------------------------------------------------------
# The operator
# ---------------------------------------------------------------------------

class _Flash(torch.autograd.Function):
    """``out = flash_gat(logits, x)`` with the recompute backward."""

    @staticmethod
    def forward(ctx, logits, x, seed, op, rate):
        out, lse = flash_fwd(op.ptr, op.col, logits, x, seed, rate,
                             op.graph.n_src)
        ctx.save_for_backward(logits, x, out, lse, seed)
        ctx.op, ctx.rate = op, rate
        return out

    @staticmethod
    def backward(ctx, gout):
        logits, x, out, lse, seed = ctx.saved_tensors
        op, gout = ctx.op, gout.contiguous()
        dl, q = flash_bwd(op.ptr, op.col, logits, x, gout, out, lse, seed,
                          ctx.rate, op.graph.n_src)
        # dx[j] = sum_{e: col_e = j} q_e gout[r_e]: the transposed SpMM
        dx = op.spmm.apply(gout, q, transpose=True) \
            if ctx.needs_input_grad[1] else None
        return dl, dx, None, None, None


class FlashGatOperator:
    """Differentiable fused attention bound to one graph
    (``flash_gat.py::FlashGATOperator``).

    ``op(logits, x)`` with per-edge ``logits`` [E_pad] in CSR order and
    destination features ``x`` [n_dst, d]::

        att = softmax_per_src_row(logits)
        out[i] = sum_e att_e * x[rcv_e]              # [n_src, d]

    and its gradient ``(dlogits [E_pad], dx)``; pad slots get no gradient.
    ``op.drop(logits, x, seed)`` applies inverted attention dropout at
    ``dropout_rate`` after the normalisation, with the keep mask hashed from
    ``(seed, edge slot)``.  Rows with no edges give zeros.
    """

    def __init__(self, graph: "BipartiteGraph", dropout_rate: float = 0.0,
                 spmm: Optional[SpmmOperator] = None):
        r = float(dropout_rate)
        if not 0.0 <= r < 1.0:
            raise ValueError(f"dropout_rate must be in [0, 1), got {r}")
        self.graph = graph
        self.spmm: SpmmOperator = spmm if spmm is not None \
            else operator_for(graph)
        self.device = self.spmm.device
        self.ptr, self.col = self.spmm.ptr, self.spmm.col
        self.dropout_rate = r

    @staticmethod
    def build(graph: "BipartiteGraph", spmm: Optional[SpmmOperator] = None,
              dropout_rate: float = 0.0) -> "FlashGatOperator":
        """The operator of ``graph``, over ``spmm``'s arrays (default: the
        graph's cached operator)."""
        return FlashGatOperator(graph, dropout_rate, spmm)

    def _apply(self, logits, x, seed, rate):
        g = self.graph
        if x.device != self.device or logits.device != self.device:
            raise ValueError(f"logits on {logits.device} and x on {x.device}, "
                             f"the operator on {self.device}")
        if logits.shape != (g.num_padded_edges,) or x.dim() != 2 \
                or x.shape[0] != g.n_dst:
            raise ValueError(f"logits {tuple(logits.shape)}, x "
                             f"{tuple(x.shape)} for a {g.n_src} x {g.n_dst} "
                             f"graph of {g.num_padded_edges} edge slots")
        return _Flash.apply(logits.contiguous(), x.contiguous(), seed, self,
                            rate)

    def __call__(self, logits: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self._apply(logits, x, self.ptr.new_zeros(1), 0.0)

    def drop(self, logits: torch.Tensor, x: torch.Tensor,
             seed: torch.Tensor) -> torch.Tensor:
        """Forward with in-kernel attention dropout at ``dropout_rate``.
        ``seed``: int32 [1] on the operator's device.  At rate 0 this
        equals ``__call__`` exactly."""
        seed = seed.reshape(1).to(device=self.device, dtype=torch.int32)
        return self._apply(logits, x, seed, self.dropout_rate)


# the JAX package's spelling
FlashGATOperator = FlashGatOperator


def flash_gat_aggregate(graph: "BipartiteGraph", logits: torch.Tensor,
                        x: torch.Tensor) -> torch.Tensor:
    """One-shot wrapper (the graph's arrays are cached by
    :func:`~msha_gnn_torch.ops.cuda.spmm.operator_for`)."""
    return FlashGatOperator.build(graph)(logits, x)
