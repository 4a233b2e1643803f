"""Fused rank-1 GAT through hand-written kernels: ``r1l_fwd_f32`` and
``r1l_bwd_f32`` (``msha_gnn_torch/csrc/rank1_gat.cu``) for the dst_linear
form, with their bfloat16 payloads ``r1l_fwd_bf16`` and ``r1l_bwd_bf16``
(``x`` stored and streamed in bfloat16, every other quantity float32),
``r1_fwd_f32`` (``rank1_gat.cu``, the same edge-run forward walk of
``csrc/gat_fwd.cuh`` with the logits formed from ``c`` and ``t``) and
``r1_bwd_f32`` (``msha_gnn_torch/csrc/flash_gat.cu``, the per-edge walk
of ``csrc/gat_bwd.cuh`` that ``flash_bwd_f32`` shares) for the generic
form, with their bfloat16 payloads ``r1_fwd_bf16`` and ``r1_bwd_bf16``.

The kernels replace ``_r1l_fwd_kernel``, ``_r1l_bwd_kernel``,
``_r1_fwd_kernel`` and ``_r1_bwd_kernel`` of
``msha_gnn_tpu/ops/pallas/rank1_gat.py``; the sources say what they
compute and what bounds them.

* :func:`r1l_fwd` and :func:`r1l_bwd` are the kernels' wrappers: they check
  their inputs, launch on the current stream and count their launches in
  :data:`fwd_launches` and :data:`bwd_launches` (bfloat16 ``x``:
  :data:`fwd_bf16_launches`, :data:`bwd_bf16_launches`).  For tensors on
  the CPU they run :func:`rank1_gat_plain` and
  :func:`rank1_gat_bwd_plain`, the plain PyTorch versions of the same
  functions and the kernels' oracles.
  :func:`rank1_gat_runs_plain` and :func:`rank1_gat_generic_runs_plain`
  mirror the forwards' edge-run walk step by step, for tests
  (``flash_gat.rank1_gat_generic_bwd_runs_plain`` the backward's).
* :func:`keep_scale_plain` is the dropout keep mask, bit for bit the JAX
  package's ``_hash01``/``_keep_scale`` and the kernels' device function
  ``gat::keep_scale`` (``csrc/gat_common.cuh``); on the card the kernels
  hash it per slot (the materialised GAT path's in the row softmax,
  ``softmax.seg_softmax_fwd_drop``).
* :func:`r1_fwd` and :func:`r1_bwd` wrap the generic kernels (counted in
  :data:`r1_fwd_launches`, :data:`r1_bwd_launches`; bfloat16 ``x``:
  :data:`r1_fwd_bf16_launches`, :data:`r1_bwd_bf16_launches`); their
  plain versions are :func:`rank1_gat_generic_plain` and
  :func:`rank1_gat_generic_bwd_plain`.
* :class:`Rank1GatOperator` binds one graph and is differentiable.  The
  dst_linear backward runs ``r1l_bwd_f32`` (``q``, ``dpre``, ``dc``,
  ``da``), then ``dx`` by :func:`assemble_dx`: the ``q``-weighted
  transposed ``csr_spmm_f32`` of ``gout`` plus ``a`` times the d = 1
  edge-row reduce of ``dpre``; the
  generic backward runs ``r1_bwd_f32`` (``att``, ``dpre``, ``dc``), then
  ``dx`` as the ``att``-weighted transposed ``csr_spmm_f32`` of ``gout``
  and ``dt`` as the edge-row reduce of ``dpre``.  With
  ``precision="bf16"`` the operator casts ``x`` to bfloat16 once a call
  and keeps that copy for the backward.  dst_linear: ``t_j = x_j . a``,
  the logits, the softmax, the aggregation and every backward quantity
  come from the bfloat16 rows in float32 (``r1l_fwd_bf16``,
  ``r1l_bwd_bf16``), and ``dx``'s ``q``-weighted SpMM streams the
  cotangent in bfloat16 (``csr_spmm_bf16``).  Generic: ``t`` is rounded
  to bfloat16 too, as the JAX operator casts its ``[x || t]`` rows
  (``rank1_gat.py:586-592``), and both kernels read the bfloat16 rows
  (``r1_fwd_bf16``, ``r1_bwd_bf16``); ``dx`` and ``dt`` stay the float32
  SpMMs of the float32 cotangent, as the JAX backward's ``z`` and ``dc``
  are float32 (``:744-754``).
"""

from __future__ import annotations

import bisect
import ctypes
import functools
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from ...utils import debug
from ..sparse import PRECISIONS
from .spmm import (ROW_TYPES, SpmmOperator, edge_rows, n_runs, operator_for,
                   sums_ws_floats, warp_run, widen)

if TYPE_CHECKING:
    from ...graph import BipartiteGraph

NEG = -1e30

# Lanes an edge in the kernels on the edge-run schedule (the forwards
# r1l_fwd_f32, r1_fwd_f32 and flash_fwd_f32, the per-edge walks
# flash_bwd_f32, r1_bwd_f32 and csr_sddmm_f32; csrc/gat_runs.cuh).
GROUPS = (8, 16, 32)
WARP = 32

# Slots a warp of r1_bwd_f32 by default (PERF.md, the sweep of RUN_SLOTS
# and GROUPS at the linkpred shapes).
R1_BWD_RUN = 64

# Launches of r1l_fwd_f32 / r1l_bwd_f32 in this process (plain counts, reset
# by callers that measure a run).  Each launch runs two grids: the edge
# runs, then the fix-up of the rows that cross runs (the forward's pieces
# merged in run order; the backward's dc pieces and the da reduce).
fwd_launches = 0
bwd_launches = 0
# Launches of the generic form's r1_fwd_f32 / r1_bwd_f32.  Each launch runs
# two grids, as r1l_fwd_f32's and r1l_bwd_f32's do: the edge runs, then the
# fix-up of the rows that cross runs (the forward's pieces merged, the
# backward's dc pieces added, in run order).
r1_fwd_launches = 0
r1_bwd_launches = 0
# Launches of r1l_fwd_bf16 / r1l_bwd_bf16 and of the generic r1_fwd_bf16 /
# r1_bwd_bf16 (two grids each, as above).
fwd_bf16_launches = 0
bwd_bf16_launches = 0
r1_fwd_bf16_launches = 0
r1_bwd_bf16_launches = 0

_lib: Optional[ctypes.CDLL] = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("rank1_gat")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.r1l_fwd_f32.argtypes = [p] * 6 + [f] * 3 + [p] * 3 + [i] * 6 + [p]
        lib.r1l_bwd_f32.argtypes = ([p] * 9 + [f] * 3 + [p] * 5 + [i] * 5
                                    + [p])
        lib.r1_fwd_f32.argtypes = [p] * 5 + [f] + [p] * 3 + [i] * 6 + [p]
        lib.r1l_fwd_bf16.argtypes = lib.r1l_fwd_f32.argtypes
        lib.r1l_bwd_bf16.argtypes = lib.r1l_bwd_f32.argtypes
        lib.r1_fwd_bf16.argtypes = lib.r1_fwd_f32.argtypes
        lib.r1l_max_warps.argtypes = [i]
        for fn in (lib.r1l_fwd_f32, lib.r1l_bwd_f32, lib.r1_fwd_f32,
                   lib.r1l_fwd_bf16, lib.r1l_bwd_bf16, lib.r1_fwd_bf16,
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


# ---------------------------------------------------------------------------
# Plain versions (the CPU path and the kernels' oracles)
# ---------------------------------------------------------------------------

def _logits(ptr, col, c, a, x, slope):
    rows = edge_rows(ptr, col.numel())
    xg = widen(x[col.long()])
    pre = c[rows] + xg @ a
    return rows, xg, pre, torch.where(pre >= 0, pre, slope * pre)


def _keep(n_edges: int, seed, rate: float, device) -> torch.Tensor:
    if rate <= 0:
        return torch.ones(n_edges, device=device)
    return keep_scale_plain(torch.arange(n_edges, device=device), seed,
                            rate).to(device)


def rank1_gat_plain(ptr, col, c, a, x, seed, rate: float, slope: float,
                    n_rows: int):
    """Plain version of ``r1l_fwd_f32`` (and, for bfloat16 ``x``, of
    ``r1l_fwd_bf16``: the rows widened after the gather) -> ``(out
    [n_rows, d], lse [n_rows])`` float32: gather, ``scatter_reduce`` amax,
    ``index_add_``."""
    rows, xg, _, logit = _logits(ptr, col, c, a, x, slope)
    m = torch.full((n_rows,), NEG, dtype=xg.dtype, device=x.device)
    m = m.scatter_reduce(0, rows, logit, "amax", include_self=True)
    p = torch.exp(logit - m[rows])
    s = xg.new_zeros(n_rows).index_add_(0, rows, p)
    w = p * _keep(col.numel(), seed, rate, x.device)
    agg = xg.new_zeros((n_rows, x.shape[1])).index_add_(0, rows,
                                                       w[:, None] * xg)
    live = s > 0
    out = torch.where(live[:, None], agg / torch.where(live, s, 1.0)[:, None],
                      0.0)
    lse = torch.where(live, m + torch.log(torch.where(live, s, 1.0)), NEG)
    return out, lse


def group_for(d: int) -> int:
    """Lanes an edge at width ``d`` in the edge-run GAT kernels: the fewest
    of :data:`GROUPS` whose lanes hold the row at 8 floats each, else the
    widest.  At d 64 that is 8, the fastest of 8, 16 and 32 for
    ``r1l_fwd_f32`` and ``flash_bwd_f32`` on the card (``PERF.md``, the
    sweep)."""
    for g in GROUPS:
        if 8 * g >= d:
            return g
    return GROUPS[-1]


def _lane_floats(group: int, d: int) -> int:
    """Floats of a row a lane holds (``gat_runs.cuh::per_lane`` for aligned
    rows)."""
    most = 8 if d % 4 == 0 else 2 if d % 2 == 0 else 1
    per = 1
    while per < most and group * per < d:
        per *= 2
    return per


def _steps(group: int, d: int) -> int:
    """Edges a group takes a step (``gat_runs.cuh::Layout::kSteps``)."""
    return max(1, 16 // _lane_floats(group, d))


def _merge(m, s, acc, m2, s2, acc2):
    """The online-softmax merge of ``(m2, s2, acc2)`` into ``(m, s, acc)``
    (``gat_runs.cuh::merge``); a piece without edges is ``(NEG, 0, 0)``."""
    m_new = torch.maximum(m, m2)
    r1, r2 = torch.exp(m - m_new), torch.exp(m2 - m_new)
    return (m_new, s2 * r2 + s * r1,
            acc2 * r2[..., None] + acc * r1[..., None])


def _fold_piece(logit, keep, xg, n_groups: int, steps: int):
    """The online softmax of one row piece as the kernel's groups take it:
    group g folds edges g, g + n_groups, ..., ``steps`` of them a step; then
    the groups merge in the kernel's order (``gat_runs.cuh::merge_groups``:
    groups 1 apart, then 2 apart, ...).  Returns group 0's ``(m, s,
    acc)``."""
    length, d = xg.shape
    g = torch.arange(n_groups)
    m = xg.new_full((n_groups,), NEG)
    s = xg.new_zeros(n_groups)
    acc = xg.new_zeros((n_groups, d))
    for eb in range(0, length, n_groups * steps):
        idx = eb + torch.arange(steps)[None, :] * n_groups + g[:, None]
        ok = idx < length
        idx = idx.clamp(max=length - 1)
        lg = torch.where(ok, logit[idx], NEG)
        m_new = torch.maximum(m, lg.max(1).values)
        rescale = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(lg - m_new[:, None]), 0.0)
        s = s * rescale + p.sum(1)
        m = m_new
        acc = acc * rescale[:, None] + ((p * keep[idx])[:, :, None]
                                        * xg[idx]).sum(1)
    o = 1
    while o < n_groups:
        m, s, acc = _merge(m, s, acc, m[g ^ o], s[g ^ o], acc[g ^ o])
        o *= 2
    return m[0], s[0], acc[0]


def _fwd_runs_plain(ptr, logit, keep, xg, n_rows: int, run: int,
                    group: int):
    """The forward walk of ``csrc/gat_fwd.cuh`` in plain PyTorch, step by
    step as the kernels take it (``runs.cuh``, ``gat_runs.cuh``), on the
    first ``E = ptr[n_rows]`` edges' logits ``logit`` [E], keep scales
    ``keep`` [E] and gathered rows ``xg`` [E, d]: runs of ``run``
    consecutive slots, ``32 / group`` groups taking every n-th edge of a
    row piece, the groups' fixed-order merge; a row inside a run is
    written, a crossing row leaves head and tail pieces that the fix-up
    merges in run order; empty rows are zeroed by the run that holds their
    slot.

    Returns ``(out [n_rows, d], lse [n_rows], writes [n_rows])``,
    ``writes`` counting how often each row was written (the kernel writes
    each once).  Slow: Python loops over runs and steps, for tests.
    """
    pl = [int(v) for v in ptr.tolist()]
    n_edges, d = pl[n_rows], xg.shape[1]
    rows = edge_rows(ptr, n_edges)
    n_groups, steps = WARP // group, _steps(group, d)
    out = xg.new_full((n_rows, d), float("nan"))
    lse = xg.new_full((n_rows,), float("nan"))
    writes = torch.zeros(n_rows, dtype=torch.int64)
    n = n_runs(n_edges, run)
    head, tail, cross = [None] * n, [None] * n, [-1] * n

    def put(r, m, s, acc):
        live = bool(s > 0)
        out[r] = acc / s if live else 0.0
        lse[r] = m + torch.log(s) if live else NEG
        writes[r] += 1

    def zero(r):
        out[r], lse[r] = 0.0, NEG
        writes[r] += 1

    if n_edges == 0:
        for r in range(n_rows):
            zero(r)
    for k in range(n):
        first, last = k * run, min(k * run + run, n_edges)
        if first >= n_edges:
            break
        row = int(rows[first])
        r = row
        while r > 0 and pl[r - 1] == first:
            r -= 1
        for empty in range(r, row):
            zero(empty)
        while True:
            rb, re = pl[row], pl[row + 1]
            pb, pe = max(rb, first), min(re, last)
            piece = _fold_piece(logit[pb:pe], keep[pb:pe], xg[pb:pe],
                                n_groups, steps)
            if rb < first:
                head[k] = piece
            elif re > last:
                tail[k], cross[k] = piece, row
            else:
                put(row, *piece)
            if re >= last:
                break
            row += 1
            while pl[row + 1] == pl[row]:
                zero(row)
                row += 1
        if last == n_edges:
            for empty in range(row + 1, n_rows):
                zero(empty)
    for k in range(n):
        if cross[k] < 0:
            continue
        m, s, acc = tail[k]
        for j in range(k + 1, (pl[cross[k] + 1] - 1) // run + 1):
            m, s, acc = _merge(m, s, acc, *head[j])
        put(cross[k], m, s, acc)
    return out, lse, writes


def _edge_walk(ptr, n_out: int, run: int, group: int, d: int):
    """The schedule of the per-edge walks of ``csrc/gat_bwd.cuh``
    (``flash_bwd_f32``, ``r1_bwd_f32``, ``csr_sddmm_f32``), step by step as
    the kernels take it (``runs.cuh``, ``gat_runs.cuh``): runs of ``run``
    consecutive slots of ``[0, n_out)``, each zeroing its pad slots past
    ``ptr[n_rows]`` and walking its row pieces, the edges of a piece handed
    to ``32 / group`` groups a step at a time.

    Yields, in a run's order: ``("pads", slots)``; ``("empty", row)`` for
    each empty row, by the run that owns it (the run holding slot
    ``ptr[row]``, the last run with edges for the rows after the last edge,
    run 0 for every row when there are no edges); ``("step", row, slots)``;
    and ``("piece", k, row, target)`` at the end of each row piece of run
    ``k``, ``target`` one of ``"out"``, ``"head"`` and ``"tail"``
    (``runs::target``).
    """
    pl = [int(v) for v in ptr.tolist()]
    n_rows = len(pl) - 1
    n_edges = pl[n_rows]
    n_groups, steps = WARP // group, _steps(group, d)
    lanes = (torch.arange(steps)[None, :] * n_groups
             + torch.arange(n_groups)[:, None]).reshape(-1)
    for k in range(n_runs(n_out, run)):
        lo, hi = k * run, min(k * run + run, n_out)
        yield "pads", torch.arange(min(max(lo, n_edges), hi), hi)
        first, last = lo, min(hi, n_edges)
        if first >= n_edges:
            if k == 0:
                for r in range(n_rows):
                    yield "empty", r
            continue
        # the last row with ptr[row] <= first: past the empty rows before it
        row = bisect.bisect_right(pl, first, 0, n_rows) - 1
        r = row
        while r > 0 and pl[r - 1] == first:
            r -= 1
        for empty in range(r, row):
            yield "empty", empty
        while True:
            rb, re = pl[row], pl[row + 1]
            pe = min(re, last)
            for eb in range(max(rb, first), pe, n_groups * steps):
                idx = eb + lanes
                yield "step", row, idx[idx < pe]
            yield "piece", k, row, ("head" if rb < first
                                    else "tail" if re > last else "out")
            if re >= last:
                break
            row += 1
            while pl[row + 1] == pl[row]:
                yield "empty", row
                row += 1
        if last == n_edges:
            for empty in range(row + 1, n_rows):
                yield "empty", empty


def rank1_gat_runs_plain(ptr, col, c, a, x, seed, rate: float, slope: float,
                         n_rows: int, run: int, group: int):
    """The walk of ``r1l_fwd_f32`` (the logit source ``kDot``:
    ``leaky(c[r] + <x[j], a>)``) in plain PyTorch, step by step as the
    kernel takes it (:func:`_fwd_runs_plain`).  ``col`` may run past
    ``ptr[n_rows]``.  Returns ``(out, lse, writes)``."""
    n_edges = int(ptr[n_rows])
    rows = edge_rows(ptr, n_edges)
    xg = x[col[:n_edges].long()]
    pre = c[rows] + xg @ a
    logit = torch.where(pre >= 0, pre, slope * pre)
    return _fwd_runs_plain(ptr, logit, _keep(n_edges, seed, rate, x.device),
                           xg, n_rows, run, group)


def rank1_gat_generic_runs_plain(ptr, col, c, t, x, slope: float,
                                 n_rows: int, run: int, group: int):
    """The walk of ``r1_fwd_f32`` (the logit source ``kRank1``:
    ``leaky(c[r] + t[j])``, no dropout; and of ``r1_fwd_bf16`` for
    bfloat16 ``x``, the rows widened) in plain PyTorch, step by step as the
    kernel takes it (:func:`_fwd_runs_plain`).  ``col`` may run past
    ``ptr[n_rows]``.  Returns ``(out, lse, writes)``."""
    n_edges = int(ptr[n_rows])
    _, pre = _generic_pre(ptr, col[:n_edges], c, t)
    logit = torch.where(pre >= 0, pre, slope * pre)
    return _fwd_runs_plain(ptr, logit, _keep(n_edges, None, 0.0, x.device),
                           widen(x[col[:n_edges].long()]), n_rows, run,
                           group)


def rank1_gat_bwd_plain(ptr, col, c, a, x, gout, out, lse, seed, rate: float,
                        slope: float, n_rows: int):
    """Plain version of ``r1l_bwd_f32`` (and of ``r1l_bwd_bf16`` for
    bfloat16 ``x``) -> ``(q [E], dpre [E]`` in CSR order``, dc [n_rows],
    da [d])`` float32; ``dx`` is :func:`assemble_dx` of ``q`` and
    ``dpre``."""
    rows, xg, pre, logit = _logits(ptr, col, c, a, x, slope)
    lse_e = lse[rows]
    live = lse_e > NEG / 2
    att = torch.where(live, torch.exp(torch.where(live, logit - lse_e, 0.0)),
                      0.0)
    q = att * _keep(col.numel(), seed, rate, x.device)
    g = gout[rows]
    dl = q * (g * xg).sum(1) - att * (gout * out).sum(1)[rows]
    dpre = torch.where(pre >= 0, dl, slope * dl)
    dc = xg.new_zeros(n_rows).index_add_(0, rows, dpre)
    return q, dpre, dc, (dpre[:, None] * xg).sum(0)


def assemble_dx(spmm: SpmmOperator, gout, a, q, dpre) -> torch.Tensor:
    """``dx[j] = sum_{e: col_e = j} (q_e gout[r_e] + dpre_e a)``, the
    dst_linear backward's ``dx`` from ``r1l_bwd_f32``'s per-edge ``q`` and
    ``dpre``: the ``q``-weighted transposed SpMM of ``gout`` plus ``a``
    times the column sums of ``dpre`` (two ``csr_spmm_f32`` launches, the
    second at d = 1), without the ``[E, d]`` rows of the sum.  A
    bfloat16 ``gout`` goes to ``csr_spmm_bf16``."""
    dx = spmm.apply(gout, q, transpose=True)
    return dx.addcmul_(spmm.reduce_edges(dpre[:, None]), a[None, :])


def _generic_pre(ptr, col, c, t):
    rows = edge_rows(ptr, col.numel())
    return rows, c[rows] + t[col.long()]


def rank1_gat_generic_plain(ptr, col, c, t, x, slope: float, n_rows: int):
    """Plain version of ``r1_fwd_f32`` (and, for bfloat16 ``x``, of
    ``r1_fwd_bf16``: the rows widened) -> ``(out [n_rows, d], lse
    [n_rows])``: the logits ``leaky(c[r] + t[col_e])``, then flash-GAT's
    plain forward on them (no dropout)."""
    from .flash_gat import flash_gat_plain

    _, pre = _generic_pre(ptr, col, c, t)
    logit = torch.where(pre >= 0, pre, slope * pre)
    return flash_gat_plain(ptr, col, logit, widen(x), None, 0.0, n_rows)


def rank1_gat_generic_bwd_plain(ptr, col, c, t, x, gout, out, lse,
                                slope: float, n_rows: int):
    """Plain version of ``r1_bwd_f32`` (and, for bfloat16 ``x``, of
    ``r1_bwd_bf16``: the rows widened) -> ``(att [E], dpre [E], dc
    [n_rows])``: flash-GAT's plain backward on the logits, ``dl`` times
    the leaky slope, and its row sums."""
    from .flash_gat import flash_gat_bwd_plain

    rows, pre = _generic_pre(ptr, col, c, t)
    logit = torch.where(pre >= 0, pre, slope * pre)
    dl, att = flash_gat_bwd_plain(ptr, col, logit, widen(x), gout, out, lse,
                                  None, 0.0, n_rows)
    dpre = torch.where(pre >= 0, dl, slope * dl)
    return att, dpre, gout.new_zeros(n_rows).index_add_(0, rows, dpre)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(dev, rate, row_types=(torch.float32,), **tensors):
    """Raises unless every tensor lies on the CUDA device ``dev``,
    contiguous, int32 (``ptr``, ``col``, ``seed``), one of ``row_types``
    (``x``) or float32 (the rest)."""
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if dev.type != "cuda":
        raise ValueError(f"the rank-1 GAT kernels run on cuda or cpu, not {dev}")
    row_type = tensors["x"].dtype
    if row_type not in row_types:
        raise TypeError(f"x must be one of {row_types}, got {row_type}")
    for name, t in tensors.items():
        want = (torch.int32 if name in ("ptr", "col", "seed")
                else row_type if name == "x" else torch.float32)
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"rate must be in [0, 1), got {rate}")


@functools.lru_cache(maxsize=None)
def _warps(d: int) -> int:
    """Warps per block: the most (up to 8) whose shared memory fits (asked
    of the library once per ``d``)."""
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


def _group(group: Optional[int], d: int) -> int:
    g = group_for(d) if group is None else int(group)
    if g not in GROUPS:
        raise ValueError(f"group must be one of {GROUPS}, got {g}")
    return g


def r1l_fwd(ptr, col, c, a, x, seed, rate: float, slope: float, n_rows: int,
            run: Optional[int] = None, group: Optional[int] = None):
    """Forward -> ``(out [n_rows, d], lse [n_rows])`` float32.

    ``ptr`` int32 [n_rows + 1], ``col`` int32 [E] (CSR, slot = index; it
    may run past ``ptr[n_rows]``: the kernel reads the edge count from
    ``ptr`` on the card), ``c`` f32 [n_rows], ``a`` f32 [d], ``x``
    [n_cols, d] float32 (``r1l_fwd_f32``) or bfloat16 (``r1l_fwd_bf16``),
    ``seed`` int32 [1] (read when ``rate > 0``).  ``run``
    slots a warp (default :func:`~.spmm.warp_run`), ``group`` lanes an edge
    (one of :data:`GROUPS`, default :func:`group_for`).  CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise.
    """
    global fwd_launches, fwd_bf16_launches
    if x.device.type == "cpu":
        return rank1_gat_plain(ptr, col, c, a, x, seed, rate, slope, n_rows)
    _check(x.device, rate, ROW_TYPES, ptr=ptr, col=col, c=c, a=a, x=x,
           seed=seed)
    d = _shapes(ptr, col, c, a, x, n_rows)
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
    bf16 = x.dtype == torch.bfloat16
    name = "r1l_fwd_bf16" if bf16 else "r1l_fwd_f32"
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, name)(
            ptr.data_ptr(), col.data_ptr(), c.data_ptr(), a.data_ptr(),
            x.data_ptr(), seed.data_ptr(), rate, _scale(rate), slope,
            out.data_ptr(), lse.data_ptr(), ws.data_ptr(), n_rows, e, run,
            group, d, _warps(d), stream)
    _raise_on(lib, rc, name)
    debug.check_kernel(name, out, lse)
    if bf16:
        fwd_bf16_launches += 1
    else:
        fwd_launches += 1
    return out, lse


def r1l_bwd(ptr, col, c, a, x, gout, out, lse, seed, rate: float,
            slope: float, n_rows: int, run: Optional[int] = None):
    """Recompute backward -> ``(q [E], dpre [E], dc [n_rows], da [d])``
    float32, ``q`` and ``dpre`` in CSR order; ``gout``, ``out`` [n_rows,
    d] and ``lse`` [n_rows] as the forward gave them.  ``col`` [E] may
    run past ``ptr[n_rows]`` (a padded edge array): the kernel reads the
    edge count from ``ptr`` on the card and gives ``q`` and ``dpre`` 0 on
    the pads.  ``x`` float32 (``r1l_bwd_f32``) or bfloat16
    (``r1l_bwd_bf16``), every other tensor float32.  ``run`` slots a warp
    (default :func:`~.spmm.warp_run`).  CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    global bwd_launches, bwd_bf16_launches
    if x.device.type == "cpu":
        return rank1_gat_bwd_plain(ptr, col, c, a, x, gout, out, lse, seed,
                                   rate, slope, n_rows)
    _check(x.device, rate, ROW_TYPES, ptr=ptr, col=col, c=c, a=a, x=x,
           gout=gout, out=out, lse=lse, seed=seed)
    d = _shapes(ptr, col, c, a, x, n_rows)
    if gout.shape != (n_rows, d) or out.shape != (n_rows, d) or \
            lse.shape != (n_rows,):
        raise ValueError(f"gout {tuple(gout.shape)}, out {tuple(out.shape)} "
                         f"and lse {tuple(lse.shape)} must be [{n_rows}, "
                         f"{d}] and [{n_rows}]")
    dev, e = x.device, col.numel()  # slots: a bound on the edges
    q = torch.empty(e, dtype=torch.float32, device=dev)
    dpre = torch.empty(e, dtype=torch.float32, device=dev)
    dc = torch.empty(n_rows, dtype=torch.float32, device=dev)
    da = torch.empty(d, dtype=torch.float32, device=dev)
    if n_rows == 0:
        return q.zero_(), dpre.zero_(), dc, da.zero_()
    run = warp_run(e) if run is None else int(run)
    ws = torch.empty(n_runs(e, run) * (3 + d), dtype=torch.float32,
                     device=dev)
    lib = _kernel_lib()
    bf16 = x.dtype == torch.bfloat16
    name = "r1l_bwd_bf16" if bf16 else "r1l_bwd_f32"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, name)(
            ptr.data_ptr(), col.data_ptr(), c.data_ptr(), a.data_ptr(),
            x.data_ptr(), gout.data_ptr(), out.data_ptr(), lse.data_ptr(),
            seed.data_ptr(), rate, _scale(rate), slope, q.data_ptr(),
            dpre.data_ptr(), dc.data_ptr(), ws.data_ptr(), da.data_ptr(),
            n_rows, e, run, d, _warps(d), stream)
    _raise_on(lib, rc, name)
    debug.check_kernel(name, q, dpre, dc, da)
    if bf16:
        bwd_bf16_launches += 1
    else:
        bwd_launches += 1
    return q, dpre, dc, da


def _generic_shapes(ptr, col, c, t, x, n_rows):
    if (x.dim() != 2 or ptr.shape != (n_rows + 1,) or col.dim() != 1
            or c.shape != (n_rows,) or t.shape != x.shape[:1]):
        raise ValueError(
            f"shapes: ptr {tuple(ptr.shape)} for {n_rows} rows, col "
            f"{tuple(col.shape)}, c {tuple(c.shape)}, t {tuple(t.shape)}, "
            f"x {tuple(x.shape)}")
    return x.shape[1]


def r1_fwd(ptr, col, c, t, x, slope: float, n_rows: int,
           run: Optional[int] = None, group: Optional[int] = None):
    """Generic forward -> ``(out [n_rows, d], lse [n_rows])`` float32 of the
    logits ``leaky(c[r] + t[col_e])``.

    ``ptr`` int32 [n_rows + 1], ``col`` int32 [E] (CSR; it may run past
    ``ptr[n_rows]``: the kernel reads the edge count from ``ptr`` on the
    card), ``c`` f32 [n_rows], ``t`` f32 [n_cols], ``x`` [n_cols, d]
    float32 (``r1_fwd_f32``) or bfloat16 (``r1_fwd_bf16``; ``t`` is read as
    given).  ``run`` slots a warp (default :func:`~.spmm.warp_run`),
    ``group`` lanes an edge (one of :data:`GROUPS`, default
    :func:`group_for`).  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise.
    """
    global r1_fwd_launches, r1_fwd_bf16_launches
    if x.device.type == "cpu":
        return rank1_gat_generic_plain(ptr, col, c, t, x, slope, n_rows)
    _check(x.device, 0.0, ROW_TYPES, ptr=ptr, col=col, c=c, t=t, x=x)
    d = _generic_shapes(ptr, col, c, t, x, n_rows)
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
    bf16 = x.dtype == torch.bfloat16
    name = "r1_fwd_bf16" if bf16 else "r1_fwd_f32"
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, name)(
            ptr.data_ptr(), col.data_ptr(), c.data_ptr(), t.data_ptr(),
            x.data_ptr(), slope, out.data_ptr(), lse.data_ptr(),
            ws.data_ptr(), n_rows, e, run, group, d, _warps(d), stream)
    _raise_on(lib, rc, name)
    debug.check_kernel(name, out, lse)
    if bf16:
        r1_fwd_bf16_launches += 1
    else:
        r1_fwd_launches += 1
    return out, lse


def r1_bwd(ptr, col, c, t, x, gout, out, lse, slope: float, n_rows: int,
           run: Optional[int] = None, group: Optional[int] = None):
    """Generic recompute backward -> ``(att [E], dpre [E], dc [n_rows])``
    float32; ``gout``, ``out`` [n_rows, d] and ``lse`` [n_rows] as the
    forward gave them.  ``col`` [E] may run past ``ptr[n_rows]``: the
    kernel reads the edge count from ``ptr`` on the card and gives ``att``
    and ``dpre`` 0 on the pads.  ``x`` float32 (``r1_bwd_f32``) or
    bfloat16 (``r1_bwd_bf16``), every other tensor float32.  ``run`` slots
    a warp (default :data:`R1_BWD_RUN`), ``group`` lanes an edge (one of
    :data:`GROUPS`, default :func:`group_for`).  CPU tensors take the
    plain version; CUDA tensors launch the kernel (two grids: the edge
    runs, then the dc of the rows that cross runs) or raise."""
    global r1_bwd_launches, r1_bwd_bf16_launches
    if x.device.type == "cpu":
        return rank1_gat_generic_bwd_plain(ptr, col, c, t, x, gout, out, lse,
                                           slope, n_rows)
    from . import flash_gat

    _check(x.device, 0.0, ROW_TYPES, ptr=ptr, col=col, c=c, t=t, x=x,
           gout=gout, out=out, lse=lse)
    d = _generic_shapes(ptr, col, c, t, x, n_rows)
    if gout.shape != (n_rows, d) or out.shape != (n_rows, d) or \
            lse.shape != (n_rows,):
        raise ValueError(f"gout {tuple(gout.shape)}, out {tuple(out.shape)} "
                         f"and lse {tuple(lse.shape)} must be [{n_rows}, "
                         f"{d}] and [{n_rows}]")
    dev, e = x.device, col.numel()
    group = _group(group, d)
    att = torch.empty(e, dtype=torch.float32, device=dev)
    dpre = torch.empty(e, dtype=torch.float32, device=dev)
    dc = torch.empty(n_rows, dtype=torch.float32, device=dev)
    if n_rows == 0:
        return att.zero_(), dpre.zero_(), dc
    run = R1_BWD_RUN if run is None else int(run)
    ws = torch.empty(sums_ws_floats(e, run, 1), dtype=torch.float32,
                     device=dev)
    lib = flash_gat._kernel_lib()
    bf16 = x.dtype == torch.bfloat16
    name = "r1_bwd_bf16" if bf16 else "r1_bwd_f32"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, name)(
            ptr.data_ptr(), col.data_ptr(), c.data_ptr(), t.data_ptr(),
            x.data_ptr(), gout.data_ptr(), out.data_ptr(), lse.data_ptr(),
            slope, att.data_ptr(), dpre.data_ptr(), dc.data_ptr(),
            ws.data_ptr(), n_rows, e, run, group, d, flash_gat.WARPS,
            stream)
    flash_gat._raise_on(lib, rc, name)
    debug.check_kernel(name, att, dpre, dc)
    if bf16:
        r1_bwd_bf16_launches += 1
    else:
        r1_bwd_launches += 1
    return att, dpre, dc


# ---------------------------------------------------------------------------
# The operator
# ---------------------------------------------------------------------------

class _Rank1Lin(torch.autograd.Function):
    """``out = rank1_gat(c, a, x)`` with the recompute backward; with the
    operator's ``precision="bf16"`` the kernels get a bfloat16 copy of
    ``x`` (made here, kept for the backward) and ``dx``'s SpMM a bfloat16
    copy of the cotangent."""

    @staticmethod
    def forward(ctx, c, a, x, seed, op, rate):
        g = op.graph
        if op.precision == "bf16":
            x = x.to(torch.bfloat16)
        out, lse = r1l_fwd(op.ptr, op.col, c, a, x, seed, rate, op.slope,
                           g.n_src)
        ctx.save_for_backward(c, a, x, out, lse, seed)
        ctx.op, ctx.rate = op, rate
        return out

    @staticmethod
    def backward(ctx, gout):
        c, a, x, out, lse, seed = ctx.saved_tensors
        op, gout = ctx.op, gout.contiguous()
        q, dpre, dc, da = r1l_bwd(op.ptr, op.col, c, a, x, gout, out, lse,
                                  seed, ctx.rate, op.slope, op.graph.n_src)
        dx = assemble_dx(op.spmm, gout.to(x.dtype), a, q, dpre) \
            if ctx.needs_input_grad[2] else None
        return dc, da, dx, None, None, None


class _Rank1Generic(torch.autograd.Function):
    """``out = rank1_gat(c, t, x)`` with the recompute backward: ``dc`` from
    ``r1_bwd_f32``, ``dx`` the att-weighted transposed SpMM of ``gout``,
    ``dt`` the edge-row reduce of ``dpre``.  With the operator's
    ``precision="bf16"`` the kernels get a bfloat16 copy of ``x`` and ``t``
    rounded to bfloat16 (made here, kept for the backward); ``gout``,
    ``dx`` and ``dt`` stay float32."""

    @staticmethod
    def forward(ctx, c, t, x, op):
        if op.precision == "bf16":
            x = x.to(torch.bfloat16)
            t = t.to(torch.bfloat16).float()
        out, lse = r1_fwd(op.ptr, op.col, c, t, x, op.slope, op.graph.n_src)
        ctx.save_for_backward(c, t, x, out, lse)
        ctx.op = op
        return out

    @staticmethod
    def backward(ctx, gout):
        c, t, x, out, lse = ctx.saved_tensors
        op, gout = ctx.op, gout.contiguous()
        att, dpre, dc = r1_bwd(op.ptr, op.col, c, t, x, gout, out, lse,
                               op.slope, op.graph.n_src)
        dt = op.spmm.reduce_edges(dpre[:, None])[:, 0] \
            if ctx.needs_input_grad[1] else None
        dx = op.spmm.apply(gout, att, transpose=True) \
            if ctx.needs_input_grad[2] else None
        return dc, dt, dx, None


class Rank1GatOperator:
    """Differentiable fused rank-1 GAT layer bound to one graph
    (``rank1_gat.py::Rank1GatOperator``).

    Generic form (``dst_linear=False``, the default): ``op(c, t, x)`` with
    ``c`` [n_src], ``t`` [n_dst], ``x`` [n_dst, d]::

        att = softmax_per_src_row(leaky_relu(c[snd] + t[rcv]))
        out[i] = sum_e att_e * x[rcv_e]              # [n_src, d]

    and its gradient ``(dc, dt, dx)``.  ``dst_linear=True``: ``op(c, a, x)``
    with ``a`` [d] and ``t = x @ a`` formed in the kernel, gradient ``(dc,
    da, dx)``; ``op.drop(c, a, x, seed)`` applies inverted attention dropout
    at ``dropout_rate`` after the normalisation, with the keep mask hashed
    from ``(seed, edge slot)``.  ``drop`` on a generic operator raises (the
    JAX operator's silently runs the dst_linear form,
    ``rank1_gat.py:861-891``).  Rows with no edges give zeros.

    ``precision="bf16"``: ``x`` (and, in the generic form, ``t``) rounded
    to bfloat16, stored and streamed so, with float32 arithmetic, about
    2^-8 relative error (the module's docstring).
    """

    def __init__(self, graph: "BipartiteGraph",
                 spmm: Optional[SpmmOperator] = None, *,
                 negative_slope: float = 0.2, precision: str = "f32",
                 dst_linear: bool = False, dropout_rate: float = 0.0):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r} (f32 | bf16)")
        r = float(dropout_rate)
        if not 0.0 <= r < 1.0:
            raise ValueError(f"dropout_rate must be in [0, 1), got {r}")
        self.graph = graph
        self.spmm: SpmmOperator = spmm if spmm is not None \
            else operator_for(graph)
        self.device = self.spmm.device
        self.ptr, self.col = self.spmm.ptr, self.spmm.col
        self.slope = float(negative_slope)
        self.dst_linear = dst_linear
        self.dropout_rate = r
        self.precision = precision

    @staticmethod
    def build(graph: "BipartiteGraph", spmm: Optional[SpmmOperator] = None,
              negative_slope: float = 0.2, precision: str = "f32",
              dst_linear: bool = False,
              dropout_rate: float = 0.0) -> "Rank1GatOperator":
        """The operator of ``graph``, over ``spmm``'s arrays (default: the
        graph's cached operator); the JAX signature less ``interpret``."""
        return Rank1GatOperator(graph, spmm, negative_slope=negative_slope,
                                precision=precision, dst_linear=dst_linear,
                                dropout_rate=dropout_rate)

    def _check(self, c, t_or_a, x):
        g = self.graph
        if x.device != self.device:
            raise ValueError(f"x is on {x.device}, the operator on "
                             f"{self.device}")
        want = (x.shape[1],) if self.dst_linear else (g.n_dst,)
        if c.shape != (g.n_src,) or x.dim() != 2 or x.shape[0] != g.n_dst \
                or t_or_a.shape != want:
            name = "a" if self.dst_linear else "t"
            raise ValueError(f"c {tuple(c.shape)}, {name} "
                             f"{tuple(t_or_a.shape)}, x {tuple(x.shape)} for "
                             f"a {g.n_src} x {g.n_dst} graph")

    def _apply(self, c, a, x, seed, rate):
        self._check(c, a, x)
        return _Rank1Lin.apply(c.contiguous(), a.contiguous(),
                               x.contiguous(), seed, self, rate)

    def __call__(self, c: torch.Tensor, t_or_a: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
        """``(c, t, x)`` in the generic form; ``(c, a, x)`` with ``t = x @
        a`` when ``dst_linear``."""
        if self.dst_linear:
            return self._apply(c, t_or_a, x, self.ptr.new_zeros(1), 0.0)
        self._check(c, t_or_a, x)
        return _Rank1Generic.apply(c.contiguous(), t_or_a.contiguous(),
                                   x.contiguous(), self)

    def drop(self, c: torch.Tensor, a: torch.Tensor, x: torch.Tensor,
             seed: torch.Tensor) -> torch.Tensor:
        """Forward with in-kernel attention dropout at ``dropout_rate``.
        ``seed``: int32 [1] on the operator's device.  At rate 0 this
        equals ``__call__`` exactly."""
        if not self.dst_linear:
            raise ValueError("drop() needs a dst_linear operator: the "
                             "generic form has no attention dropout")
        seed = seed.reshape(1).to(device=self.device, dtype=torch.int32)
        return self._apply(c, a, x, seed, self.dropout_rate)
