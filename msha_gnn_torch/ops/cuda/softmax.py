"""Softmax of per-edge logits over CSR rows through the hand-written
kernels ``seg_softmax_fwd_f32`` and ``seg_softmax_bwd_f32``
(``msha_gnn_torch/csrc/softmax.cu``).

The kernels replace ``_stats_kernel``, ``_expand_kernel`` and
``_rowsum_kernel`` of ``msha_gnn_tpu/ops/pallas/softmax.py``; the source
says what they compute, what bounds them (bytes) and how they share one
walk of edge runs (two grids a call).

* :func:`seg_softmax_fwd` and :func:`seg_softmax_bwd` are the kernels'
  wrappers: they check their inputs, launch on the current stream and
  count their launches in :data:`fwd_launches` and :data:`bwd_launches`
  (one a call).  For tensors on the CPU they run
  :func:`seg_softmax_fwd_plain` and :func:`seg_softmax_bwd_plain`, the
  plain PyTorch versions of the same functions and the kernels' oracles.
* :func:`seg_softmax_fwd_drop` and :func:`seg_softmax_bwd_drop` launch the
  same kernels with the attention's dropout folded in (the keep mask of
  ``rank1_gat.py::_keep_scale``, hashed per slot in the walk): the forward
  also gives ``att_k = att * k``, the backward takes the cotangent of
  ``att_k``.  Their launches count in :data:`fwd_launches` and
  :data:`bwd_launches` too, and in :data:`fwd_drop_launches` and
  :data:`bwd_drop_launches`; their plain versions compose the plain
  softmax with ``rank1_gat.keep_scale_plain``.
* :func:`seg_softmax_fwd_runs_plain`, :func:`seg_softmax_bwd_runs_plain`
  and their dropout forms mirror the kernels' walk (runs, head and tail
  pieces, crossing rows merged in run order) step by step, for tests.
* :func:`seg_expand` wraps ``seg_expand_f32`` (the same source), the
  row broadcast ``out[e] = v[row of e]`` that ``_expand_kernel`` computes
  alone in the TPU operator, counted in :data:`expand_launches`; its plain
  version is :func:`seg_expand_plain`.
* :class:`SegmentSoftmaxOperator` (``softmax.py::SegmentSoftmaxOperator``)
  binds one edge sort and a static per-edge mask and is differentiable.
  Its ``broadcast_rows(v)`` is the differentiable ``v[row] ->
  v[senders[e]]`` of ``training/scale.py``'s logits: one ``seg_expand_f32``
  forward, and the adjoint's row sums (``_rowsum_kernel`` alone) one
  ``seg_reduce_f32`` at d = 1 (``spmm.row_sums``).  :func:`edge_softmax_drop`
  is the materialised GAT layer's attention with its dropout: the row
  softmax of the graph's operator times the keep mask, in one launch each
  way.
"""

from __future__ import annotations

import bisect
import ctypes
from typing import TYPE_CHECKING, Callable, Optional

import torch

from ... import resolve_device
from ...utils import debug
from .rank1_gat import _scale, keep_scale_plain
from .spmm import cached_for, edge_rows, n_runs, row_sums

if TYPE_CHECKING:
    from ...graph import BipartiteGraph

NEG = -1e30

# Launches of seg_softmax_fwd_f32 / seg_softmax_bwd_f32 and of the row
# broadcast seg_expand_f32 in this process (plain counts, reset by callers
# that measure a run).
fwd_launches = 0
bwd_launches = 0
expand_launches = 0
# Those of them with the dropout folded in.
fwd_drop_launches = 0
bwd_drop_launches = 0

# Slots a run that a warp holds at most (16 a lane).
MAX_WARP_RUN = 512
# Slots a run by default (PERF.md, the sweep of RUN_SLOTS at the linkpred
# shapes).
RUN = 128
RUN_SLOTS = (16, 32, 64, 128, 256, 512)
# Slots a warp of seg_expand_f32 (8 a lane).
EXPAND_RUN = 256

_lib: Optional[ctypes.CDLL] = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("softmax")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.seg_softmax_fwd_f32.argtypes = [p] * 8 + [f] * 2 + [i] * 4 + [p]
        lib.seg_softmax_bwd_f32.argtypes = [p] * 6 + [f] * 2 + [i] * 4 + [p]
        lib.seg_expand_f32.argtypes = [p] * 3 + [i] * 4 + [p]
        for fn in (lib.seg_softmax_fwd_f32, lib.seg_softmax_bwd_f32,
                   lib.seg_expand_f32):
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


def seg_expand_plain(ptr: torch.Tensor, v: torch.Tensor,
                     n_out: int) -> torch.Tensor:
    """Plain version of ``seg_expand_f32`` -> ``out [n_out]``: ``v`` gathered
    at each edge's row, 0 on the pads past ``ptr[-1]``."""
    e = int(ptr[-1])
    out = v.new_zeros(n_out)
    out[:e] = v[edge_rows(ptr, e)]
    return out


def seg_expand(ptr: torch.Tensor, v: torch.Tensor, n_out: int,
               n_edges: int, run: Optional[int] = None) -> torch.Tensor:
    """The row broadcast ``out[e] = v[r]`` for each edge ``e`` of row ``r``
    -> [n_out] float32, 0 on the pads ``[n_edges, n_out)``; ``ptr`` int32
    [n_rows + 1] with ``ptr[-1] = n_edges``, ``v`` f32 [n_rows].  ``run``
    slots a warp (default :data:`EXPAND_RUN`).  CPU tensors take
    :func:`seg_expand_plain`; CUDA tensors launch ``seg_expand_f32`` or
    raise."""
    global expand_launches
    if v.device.type == "cpu":
        return seg_expand_plain(ptr, v, n_out)
    _check("seg_expand_f32", v.device, ptr=ptr, v=v)
    n_rows = ptr.numel() - 1
    if v.shape != (n_rows,) or not 0 <= n_edges <= n_out:
        raise ValueError(f"v {tuple(v.shape)} for {n_rows} rows, {n_edges} "
                         f"edges in {n_out} slots")
    out = torch.empty(n_out, dtype=torch.float32, device=v.device)
    if n_rows == 0:
        return out.zero_()
    run = EXPAND_RUN if run is None else int(run)
    lib = _kernel_lib()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = lib.seg_expand_f32(ptr.data_ptr(), v.data_ptr(), out.data_ptr(),
                                n_rows, n_edges, n_out, run, stream)
    _raise_on(lib, rc, "seg_expand_f32")
    debug.check_kernel("seg_expand_f32", out)
    expand_launches += 1
    return out


def _keep(n_out: int, seed, rate: float, device) -> torch.Tensor:
    """The keep scales of slots ``0..n_out-1``."""
    return keep_scale_plain(torch.arange(n_out, device=device), seed, rate)


def seg_softmax_fwd_drop_plain(ptr: torch.Tensor, logits: torch.Tensor,
                               mask: Optional[torch.Tensor], n_edges: int,
                               seed, rate: float):
    """Plain version of ``seg_softmax_fwd_f32`` with dropout -> ``(att,
    att_k, lse)``: :func:`seg_softmax_fwd_plain`, then ``att_k = att *
    keep_scale_plain``."""
    att, lse = seg_softmax_fwd_plain(ptr, logits, mask, n_edges)
    return att, att * _keep(att.numel(), seed, rate, att.device), lse


def seg_softmax_bwd_drop_plain(ptr: torch.Tensor, att: torch.Tensor,
                               g_k: torch.Tensor, n_edges: int, seed,
                               rate: float) -> torch.Tensor:
    """Plain version of ``seg_softmax_bwd_f32`` with dropout: the VJP of
    ``att_k = att * k`` for its cotangent ``g_k``,
    :func:`seg_softmax_bwd_plain` of ``g_k * k``."""
    return seg_softmax_bwd_plain(
        ptr, att, g_k * _keep(att.numel(), seed, rate, att.device), n_edges)


def _tree_merge(pieces: list, merge: Callable):
    """A crossing row's pieces in run order merged as the kernels merge
    them: in batches of 32, each by a balanced tree over neighbours
    (``((p0 + p1) + (p2 + p3)) + ...``; a piece without a neighbour goes up
    as it is, as the kernels' identity pieces let it), the batches left to
    right."""
    st = None
    for b in range(0, len(pieces), 32):
        level = pieces[b:b + 32]
        while len(level) > 1:
            level = [merge(level[i], level[i + 1]) if i + 1 < len(level)
                     else level[i] for i in range(0, len(level), 2)]
        st = level[0] if st is None else merge(st, level[0])
    return st


def _runs_walk(ptr: torch.Tensor, n_edges: int, n_slots: int, run: int,
               reduce: Callable, merge: Callable, value: Callable,
               emit: Callable, put_row: Callable) -> None:
    """The schedule of both kernels (``csrc/softmax.cu``), step by step:
    grid 1 (each run zeroes its pads, reduces its row pieces, writes the
    rows inside it and leaves the crossing rows' head and tail pieces, the
    empty rows it owns written as ``value(None)``), then grid 2 (each run
    merges the pieces of the crossing rows that touch it, the row its first
    slot continues and the row that begins in it, as :func:`_tree_merge`
    does, and writes their slots in the run; the run where such a row
    begins writes its row value).

    ``reduce(pb, pe)`` is a row piece's reduction, ``merge(a, b)`` the
    pieces' merge, ``value(piece)`` the row's value (``piece`` None for an
    empty row), ``emit(pb, pe, val)`` writes the slots ``[pb, pe)`` (``val``
    None for pads) and ``put_row(r, val)`` the row's own output."""
    pl = [int(v) for v in ptr.tolist()]
    n_rows = len(pl) - 1
    nr = n_runs(n_slots, run)
    head, tail = [None] * nr, [None] * nr
    cross, hrow = [-1] * nr, [-1] * nr
    for k in range(nr):                                  # grid 1
        first, last = k * run, min(k * run + run, n_slots)
        ef = min(last, n_edges)
        emit(max(first, n_edges), last, None)
        if first >= n_edges:
            if k == 0:
                for r in range(n_rows):
                    put_row(r, value(None))
            continue
        row = bisect.bisect_right(pl, first, 0, n_rows) - 1
        r = row
        while r > 0 and pl[r - 1] == first:
            r -= 1
        for empty in range(r, row):
            put_row(empty, value(None))
        hrow[k] = row if pl[row] < first else -1
        while True:
            rb, re = pl[row], pl[row + 1]
            pb, pe = max(rb, first), min(re, ef)
            piece = reduce(pb, pe)
            if rb < first:
                head[k] = piece
            elif re > ef:
                tail[k], cross[k] = piece, row
            else:
                val = value(piece)
                put_row(row, val)
                emit(pb, pe, val)
            if re >= ef:
                break
            row += 1
            while pl[row + 1] == pl[row]:
                put_row(row, value(None))
                row += 1
        if ef == n_edges:
            for empty in range(row + 1, n_rows):
                put_row(empty, value(None))
    for k in range(nr):                                  # grid 2
        first = k * run
        if first >= n_edges:
            continue
        ef = min(first + run, n_slots, n_edges)
        for r, begins_here in ((hrow[k], False), (cross[k], True)):
            if r < 0:
                continue
            rb, re = pl[r], pl[r + 1]
            k0, k_end = rb // run, (re - 1) // run
            val = value(_tree_merge([tail[k0]] + head[k0 + 1:k_end + 1],
                                    merge))
            if begins_here:
                put_row(r, val)
            emit(max(rb, first), min(re, ef), val)


def seg_softmax_fwd_runs_plain(ptr: torch.Tensor, logits: torch.Tensor,
                               mask: Optional[torch.Tensor], n_edges: int,
                               run: int):
    """The walk of ``seg_softmax_fwd_f32`` in plain PyTorch, step by step
    (:func:`_runs_walk`): a piece is ``(m, s)`` over its unmasked edges,
    merged by the online-softmax merge, in float32.

    Returns ``(att [n_out], lse [n_rows], att_writes, lse_writes)``, the
    writes counting how often each slot and row was written (the kernel
    writes each once).  Slow: Python loops over runs, for tests."""
    att, _, lse, att_writes, lse_writes = _fwd_runs(ptr, logits, mask,
                                                    n_edges, run, None)
    return att, lse, att_writes, lse_writes


def seg_softmax_fwd_drop_runs_plain(ptr: torch.Tensor, logits: torch.Tensor,
                                    mask: Optional[torch.Tensor],
                                    n_edges: int, seed, rate: float,
                                    run: int):
    """The walk of ``seg_softmax_fwd_f32`` with dropout: that of
    :func:`seg_softmax_fwd_runs_plain`, each slot's ``att_k = att * k``
    written where its ``att`` is.  Returns ``(att, att_k, lse, att_writes,
    lse_writes)``."""
    return _fwd_runs(ptr, logits, mask, n_edges, run,
                     _keep(logits.numel(), seed, rate, logits.device))


def _fwd_runs(ptr, logits, mask, n_edges: int, run: int, keep):
    """Both forward mirrors: ``keep`` the slots' keep scales, or None."""
    n_rows, n_out = ptr.numel() - 1, logits.numel()
    att = logits.new_full((n_out,), float("nan"))
    att_k = None if keep is None else att.clone()
    lse = logits.new_full((n_rows,), float("nan"))
    att_writes = torch.zeros(n_out, dtype=torch.int64)
    lse_writes = torch.zeros(n_rows, dtype=torch.int64)
    kept = (torch.ones(n_out, dtype=torch.bool) if mask is None
            else mask.bool())
    neg = logits.new_tensor(NEG)

    def reduce(pb, pe):
        live = logits[pb:pe][kept[pb:pe]]
        if live.numel() == 0:
            return neg, logits.new_tensor(0.0)
        m = live.max()
        return m, torch.exp(live - m).sum()

    def merge(a, b):
        m = torch.maximum(a[0], b[0])
        return m, a[1] * torch.exp(a[0] - m) + b[1] * torch.exp(b[0] - m)

    def value(piece):
        m, s = (neg, logits.new_tensor(0.0)) if piece is None else piece
        return m + torch.log(torch.clamp(s, min=1e-30))

    def emit(pb, pe, val):
        if val is None:
            att[pb:pe] = 0.0
        else:
            att[pb:pe] = torch.where(kept[pb:pe],
                                     torch.exp(logits[pb:pe] - val), 0.0)
        if att_k is not None:
            att_k[pb:pe] = att[pb:pe] * keep[pb:pe]
        att_writes[pb:pe] += 1

    def put_row(r, val):
        lse[r] = val
        lse_writes[r] += 1

    _runs_walk(ptr, n_edges, n_out, run, reduce, merge, value, emit, put_row)
    return att, att_k, lse, att_writes, lse_writes


def seg_softmax_bwd_runs_plain(ptr: torch.Tensor, att: torch.Tensor,
                               g: torch.Tensor, n_edges: int, run: int):
    """The walk of ``seg_softmax_bwd_f32`` in plain PyTorch, step by step
    (:func:`_runs_walk`): a piece is the sum of ``att g`` over its edges,
    pieces added in run order.

    Returns ``(dl [n_out], writes [n_out])``.  Slow: for tests."""
    n_out = att.numel()
    dl = att.new_full((n_out,), float("nan"))
    writes = torch.zeros(n_out, dtype=torch.int64)

    def emit(pb, pe, val):
        if val is None:
            dl[pb:pe] = 0.0
        else:
            a = att[pb:pe]
            dl[pb:pe] = a * g[pb:pe] - a * val
        writes[pb:pe] += 1

    _runs_walk(ptr, n_edges, n_out, run,
               lambda pb, pe: (att[pb:pe] * g[pb:pe]).sum(),
               lambda a, b: a + b,
               lambda piece: att.new_tensor(0.0) if piece is None else piece,
               emit, lambda r, val: None)
    return dl, writes


def seg_softmax_bwd_drop_runs_plain(ptr: torch.Tensor, att: torch.Tensor,
                                    g_k: torch.Tensor, n_edges: int, seed,
                                    rate: float, run: int):
    """The walk of ``seg_softmax_bwd_f32`` with dropout: the cotangent of
    ``att_k`` scaled by each slot's keep scale as the kernel loads it, then
    :func:`seg_softmax_bwd_runs_plain`.  Returns ``(dl, writes)``."""
    return seg_softmax_bwd_runs_plain(
        ptr, att, g_k * _keep(att.numel(), seed, rate, att.device), n_edges,
        run)


def _run_length(run: Optional[int]) -> int:
    """``run`` or the module's default, checked."""
    run = RUN if run is None else int(run)
    if not 1 <= run <= MAX_WARP_RUN:
        raise ValueError(f"run must be in [1, {MAX_WARP_RUN}], got {run}")
    return run


def ws_floats(n_slots: int, run: int) -> int:
    """Floats of the kernels' workspace, a run's: its head and tail pieces
    (two floats each), the bounds of its head and tail rows (two int32
    each) and ``cross`` (one int32)."""
    return 9 * n_runs(n_slots, run)


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


def _workspace(ws: Optional[torch.Tensor], n_slots: int, run: int,
               dev: torch.device) -> torch.Tensor:
    """``ws`` checked (float32, contiguous, on ``dev``, at least
    :func:`ws_floats` long), or a new one."""
    need = ws_floats(n_slots, run)
    if ws is None:
        return torch.empty(need, dtype=torch.float32, device=dev)
    if (ws.device != dev or ws.dtype != torch.float32
            or not ws.is_contiguous() or ws.numel() < need):
        raise ValueError(f"ws must be {need} contiguous float32 on {dev}, "
                         f"got {ws.numel()} {ws.dtype} on {ws.device}")
    return ws


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.seg_softmax_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (error {rc})")


def _seed_of(seed, dev: torch.device) -> torch.Tensor:
    if (not isinstance(seed, torch.Tensor) or seed.dtype != torch.int32
            or seed.numel() != 1 or seed.device != dev):
        raise TypeError(f"seed must be one int32 on {dev}")
    return seed


def _fwd(ptr, logits, mask, n_edges: int, run, ws, seed, rate: float):
    """Both forward wrappers: ``(att, att_k or None, lse)``."""
    global fwd_launches, fwd_drop_launches
    given = dict(ptr=ptr, logits=logits)
    if mask is not None:
        given["mask"] = mask
        if mask.shape != logits.shape:
            raise ValueError(f"mask {tuple(mask.shape)} and logits "
                             f"{tuple(logits.shape)} differ")
    _check("seg_softmax_fwd_f32", logits.device, **given)
    run = _run_length(run)
    n_rows, n_out = ptr.numel() - 1, logits.numel()
    dev = logits.device
    att = torch.empty(n_out, dtype=torch.float32, device=dev)
    att_k = None if seed is None else torch.empty_like(att)
    lse = torch.empty(n_rows, dtype=torch.float32, device=dev)
    if n_rows == 0:
        return att.zero_(), None if att_k is None else att_k.zero_(), lse
    ws = _workspace(ws, n_out, run, dev)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.seg_softmax_fwd_f32(
            ptr.data_ptr(), logits.data_ptr(),
            None if mask is None else mask.data_ptr(), att.data_ptr(),
            None if att_k is None else att_k.data_ptr(), lse.data_ptr(),
            ws.data_ptr(), None if seed is None else seed.data_ptr(), rate,
            _scale(rate), n_rows, n_edges, n_out, run, stream)
    _raise_on(lib, rc, "seg_softmax_fwd_f32")
    debug.check_kernel("seg_softmax_fwd_f32", att, lse,
                       *(() if att_k is None else (att_k,)))
    fwd_launches += 1
    fwd_drop_launches += seed is not None
    return att, att_k, lse


def seg_softmax_fwd(ptr: torch.Tensor, logits: torch.Tensor,
                    mask: Optional[torch.Tensor], n_edges: int,
                    run: Optional[int] = None,
                    ws: Optional[torch.Tensor] = None):
    """Row softmax of ``logits`` [n_out] (CSR order; ``n_edges = ptr[-1]
    <= n_out``) -> ``(att [n_out], lse [n_rows])`` float32; ``mask`` bool
    [n_out] or None.  Masked edges and pad slots get 0.  ``run`` slots a
    run (1 to :data:`MAX_WARP_RUN`, default :data:`RUN`); ``ws`` the
    kernels' workspace (:func:`ws_floats` float32), allocated when None:
    every call rewrites it before reading it, so calls ordered on one
    stream may share one.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if logits.device.type == "cpu":
        return seg_softmax_fwd_plain(ptr, logits, mask, n_edges)
    att, _, lse = _fwd(ptr, logits, mask, n_edges, run, ws, None, 0.0)
    return att, lse


def seg_softmax_fwd_drop(ptr: torch.Tensor, logits: torch.Tensor,
                         mask: Optional[torch.Tensor], n_edges: int,
                         seed: torch.Tensor, rate: float,
                         run: Optional[int] = None,
                         ws: Optional[torch.Tensor] = None):
    """:func:`seg_softmax_fwd` with the attention's dropout -> ``(att,
    att_k, lse)``: ``att_k = att * k``, ``k`` the keep scale of each slot
    (``rank1_gat.keep_scale_plain`` of ``seed``, one int32 on the logits'
    device, at ``rate``), formed in the same launch, bit for bit that
    product.  CPU tensors take :func:`seg_softmax_fwd_drop_plain`."""
    if logits.device.type == "cpu":
        return seg_softmax_fwd_drop_plain(ptr, logits, mask, n_edges, seed,
                                          rate)
    return _fwd(ptr, logits, mask, n_edges, run, ws,
                _seed_of(seed, logits.device), rate)


def _bwd(ptr, att, g, n_edges: int, run, ws, seed, rate: float):
    """Both backward wrappers."""
    global bwd_launches, bwd_drop_launches
    _check("seg_softmax_bwd_f32", att.device, ptr=ptr, att=att, g=g)
    if g.shape != att.shape:
        raise ValueError(f"g {tuple(g.shape)} and att {tuple(att.shape)} "
                         "differ")
    run = _run_length(run)
    n_rows, n_out = ptr.numel() - 1, att.numel()
    dev = att.device
    dl = torch.empty(n_out, dtype=torch.float32, device=dev)
    if n_rows == 0:
        return dl.zero_()
    ws = _workspace(ws, n_out, run, dev)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.seg_softmax_bwd_f32(
            ptr.data_ptr(), att.data_ptr(), g.data_ptr(), dl.data_ptr(),
            ws.data_ptr(), None if seed is None else seed.data_ptr(), rate,
            _scale(rate), n_rows, n_edges, n_out, run, stream)
    _raise_on(lib, rc, "seg_softmax_bwd_f32")
    debug.check_kernel("seg_softmax_bwd_f32", dl)
    bwd_launches += 1
    bwd_drop_launches += seed is not None
    return dl


def seg_softmax_bwd(ptr: torch.Tensor, att: torch.Tensor, g: torch.Tensor,
                    n_edges: int, run: Optional[int] = None,
                    ws: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The softmax's vector-Jacobian product ``dl [n_out]`` for ``att`` as
    the forward gave it and the cotangent ``g`` [n_out]; pad slots get 0.
    ``run`` and ``ws`` as for :func:`seg_softmax_fwd`.  CPU tensors take
    the plain version."""
    if att.device.type == "cpu":
        return seg_softmax_bwd_plain(ptr, att, g, n_edges)
    return _bwd(ptr, att, g, n_edges, run, ws, None, 0.0)


def seg_softmax_bwd_drop(ptr: torch.Tensor, att: torch.Tensor,
                         g_k: torch.Tensor, n_edges: int,
                         seed: torch.Tensor, rate: float,
                         run: Optional[int] = None,
                         ws: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The VJP of :func:`seg_softmax_fwd_drop`'s ``att_k`` for its
    cotangent ``g_k``: :func:`seg_softmax_bwd` of ``g_k * k``, the product
    formed per slot in the same launch.  CPU tensors take
    :func:`seg_softmax_bwd_drop_plain`."""
    if att.device.type == "cpu":
        return seg_softmax_bwd_drop_plain(ptr, att, g_k, n_edges, seed, rate)
    return _bwd(ptr, att, g_k, n_edges, run, ws, _seed_of(seed, att.device),
                rate)


# ---------------------------------------------------------------------------
# The operator
# ---------------------------------------------------------------------------

class _SoftmaxFn(torch.autograd.Function):
    """``att = softmax_per_row(l)`` with ``dl = att*g - att*rowsum(att*g)``,
    as ``softmax.py::SegmentSoftmaxOperator``'s VJP."""

    @staticmethod
    def forward(ctx, logits, op):
        att, _ = seg_softmax_fwd(op.ptr, logits, op.mask, op.num_edges,
                                 op.run, op.ws)
        ctx.op = op
        ctx.save_for_backward(att)
        return att

    @staticmethod
    def backward(ctx, g):
        (att,) = ctx.saved_tensors
        op = ctx.op
        return seg_softmax_bwd(op.ptr, att, g.contiguous(), op.num_edges,
                               op.run, op.ws), None


class _SoftmaxDropFn(torch.autograd.Function):
    """``att_k = softmax_per_row(l) * k`` (``k`` the keep scale of each
    slot) with ``dl = att*g - att*rowsum(att*g)`` for ``g = g_k * k``: the
    VJP of the softmax followed by the dropout multiply, in one launch each
    way."""

    @staticmethod
    def forward(ctx, logits, op, seed, rate):
        att, att_k, _ = seg_softmax_fwd_drop(op.ptr, logits, op.mask,
                                             op.num_edges, seed, rate,
                                             op.run, op.ws)
        ctx.op, ctx.rate = op, rate
        ctx.save_for_backward(att, seed)
        return att_k

    @staticmethod
    def backward(ctx, g_k):
        att, seed = ctx.saved_tensors
        op = ctx.op
        return seg_softmax_bwd_drop(op.ptr, att, g_k.contiguous(),
                                    op.num_edges, seed, ctx.rate, op.run,
                                    op.ws), None, None, None


class _BroadcastFn(torch.autograd.Function):
    """``out[e] = v[row of e]`` (pads 0) with the adjoint ``dv[r] = sum_{e
    in r} g[e]``, as ``SegmentSoftmaxOperator.broadcast_rows``'s VJP
    (``_expand`` forward, ``_rowsum`` backward)."""

    @staticmethod
    def forward(ctx, v, op):
        ctx.op = op
        return seg_expand(op.ptr, v, op.num_padded_edges, op.num_edges)

    @staticmethod
    def backward(ctx, g):
        op = ctx.op
        n_rows = op.ptr.numel() - 1
        return row_sums(g.contiguous()[:, None], op.ptr,
                        n_rows=n_rows)[:, 0], None


class SegmentSoftmaxOperator:
    """Differentiable softmax of per-edge logits over each CSR row, bound
    to one edge sort (``softmax.py::SegmentSoftmaxOperator``).

    ``senders`` [E_pad] (CSR order; slots past ``row_ptr[-1]`` are pads),
    ``row_ptr`` [n_rows + 1], ``mask``: a static per-edge validity [E_pad]
    or None.  Masked edges get attention 0 and take no part in their row's
    denominator, so a fully masked row gives zeros; pad slots always get 0.
    ``op(logits [E_pad])`` -> ``att [E_pad]``; ``op.broadcast_rows(v
    [n_rows])`` -> ``v[senders] [E_pad]``, differentiable, the pads 0.  On
    the card the operator holds one kernel workspace (``ws``) for all its
    softmax calls, which run in order on the current stream.
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
        self.run = RUN
        self.ws = (torch.empty(ws_floats(self.num_padded_edges, RUN),
                               dtype=torch.float32, device=dev)
                   if dev.type == "cuda" else None)

    @staticmethod
    def build(graph: "BipartiteGraph",
              host: Optional["BipartiteGraph"] = None
              ) -> "SegmentSoftmaxOperator":
        """The operator of ``graph``'s rows (``per="src"``), on the graph's
        device, its row pointer read from ``host`` (the same graph on the
        CPU) when given.  The JAX build masks ``senders < n_src``; here
        that mask needs no bytes: it is False only on the pad slots past
        ``row_ptr[-1]``, which the kernels never visit and write as 0."""
        src = graph if host is None else host
        return SegmentSoftmaxOperator(src.senders, src.row_ptr, src.n_src,
                                      device=graph.device)

    def _checked(self, logits: torch.Tensor) -> torch.Tensor:
        if logits.device != self.device:
            raise ValueError(f"logits are on {logits.device}, the operator "
                             f"on {self.device}")
        if logits.shape != (self.num_padded_edges,):
            raise ValueError(f"logits must be [{self.num_padded_edges}], got "
                             f"{tuple(logits.shape)}")
        return logits.contiguous()

    def __call__(self, logits: torch.Tensor) -> torch.Tensor:
        return _SoftmaxFn.apply(self._checked(logits), self)

    def broadcast_rows(self, v: torch.Tensor) -> torch.Tensor:
        """``v[row] -> v[senders[e]]`` for the edge slots [E_pad] (the pads
        0), differentiable: one ``seg_expand_f32`` launch forward, one
        ``seg_reduce_f32`` at d = 1 backward (the row sums of the
        cotangent; the pads add nothing)."""
        n_rows = self.ptr.numel() - 1
        if v.device != self.device or v.shape != (n_rows,):
            raise ValueError(f"v must be [{n_rows}] on {self.device}, got "
                             f"{tuple(v.shape)} on {v.device}")
        return _BroadcastFn.apply(v.float().contiguous(), self)


def softmax_operator_for(graph: "BipartiteGraph",
                         host: Optional["BipartiteGraph"] = None
                         ) -> SegmentSoftmaxOperator:
    """The cached :class:`SegmentSoftmaxOperator` of ``graph`` (a first
    build reads ``host``, the same graph on the CPU, when given)."""
    return cached_for(graph, SegmentSoftmaxOperator.build, host)


def edge_softmax_cuda(graph: "BipartiteGraph",
                      logits: torch.Tensor) -> torch.Tensor:
    """One-shot row softmax of per-edge logits (``edge_softmax_pallas``,
    ``edge_softmax(per="src", impl="cuda")``) on the graph's cached
    operator."""
    return softmax_operator_for(graph)(logits)


def edge_softmax_drop(graph: "BipartiteGraph", logits: torch.Tensor,
                      seed: torch.Tensor, rate: float) -> torch.Tensor:
    """``edge_softmax(graph, logits, impl="cuda")`` times the dropout keep
    mask of each edge slot (``rank1_gat.keep_scale_plain(slots, seed,
    rate)``), differentiable: the attention of the materialised GAT layer
    in training, one ``seg_softmax_fwd_f32`` launch forward and one
    ``seg_softmax_bwd_f32`` backward on the graph's cached operator.
    ``seed`` one int32 on the logits' device, ``0 < rate < 1``."""
    op = softmax_operator_for(graph)
    return _SoftmaxDropFn.apply(op._checked(logits), op, seed, float(rate))
