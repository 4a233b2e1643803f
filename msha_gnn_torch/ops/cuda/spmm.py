"""CSR SpMM through the hand-written kernels of
``msha_gnn_torch/csrc/spmm.cu``: ``csr_spmm_f32``, ``seg_reduce_f32`` and
``csr_spmm_dw_f32``, and the bfloat16-row forms ``csr_spmm_bf16`` and
``csr_spmm_dw_bf16``.

They replace five TPU kernels of ``msha_gnn_tpu/ops/pallas/spmm.py``:
``_visit_kernel`` and ``_hub_kernel`` (``csr_spmm_f32``), ``_reduce_kernel``
(``seg_reduce_f32``), ``_visit_dw_kernel`` and ``_hub_dw_kernel``
(``csr_spmm_dw_f32``), and their bfloat16 payloads (``csr_spmm_bf16``,
``csr_spmm_dw_bf16``: the same walks over rows stored in bfloat16, every
product and sum in float32); the source says why one CSR walk serves them
all and what bounds it (bytes).

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
  (CSR order) is one launch of ``csr_sddmm_f32``
  (:mod:`msha_gnn_torch.ops.cuda.sddmm`) over the CSR direction, as the JAX
  VJP runs ``_sddmm_split`` over its forward direction in both cases:
  ``dw = sddmm(g, x)`` for ``A @ x`` and ``dw = sddmm(x, g)`` for
  ``A.T @ x``.
  With ``precision="bf16"`` the operator casts ``x`` to bfloat16 once a
  call (and keeps that copy for the backward), launches
  ``csr_spmm_bf16``, and streams the cotangent in bfloat16 to the
  transposed launch, as the JAX operator's VJP does
  (``spmm.py:1240-1275``, ``_direction_apply`` at ``:636-655``); ``dw``
  is formed from the two bfloat16 operands in float32.  That is
  ``ops.sparse.spmm(precision="bf16")``'s function.
  With ``fused_bwd=True`` (the JAX operator's flag, off by default there
  too) that backward is one launch of ``csr_spmm_dw_f32`` instead, which
  gives ``dx`` and ``dw`` together: the per-edge walk of
  ``csrc/gat_bwd.cuh`` on the edge runs, each gathered row used for the
  dot and the row sum, into a workspace the operator holds.
* :meth:`SpmmOperator.reduce_edges` sums per-edge rows into their
  receivers, ``out[j] = sum_{e: rcv_e = j} z[e]``: the kernel over the CSC
  pointer with the CSC->CSR edge ids as columns and no weights, which the
  kernel reads as unit weights (the rank-1 GAT backwards' column sums of
  ``dpre``, at d = 1).
* :func:`segment_reduce_sorted` (``spmm.py::segment_reduce_sorted``) sums
  rows of values sorted by segment over their CSR pointer, one launch of
  ``seg_reduce_f32``; :func:`row_sums` is the same without the senders
  (the row broadcast's adjoint, ``softmax.py``).

Each wrapper counts its launches (:data:`launches`, :data:`seg_launches`,
:data:`dw_launches`) and runs its plain PyTorch version, the kernel's
oracle, for tensors on the CPU.  :func:`csr_spmm_runs_plain` and
:func:`csr_spmm_dw_runs_plain` mirror the kernels' edge-run walks step by
step, for tests, and :func:`fixup_runs_plain` the fix-up of the rows that
cross runs that they share; :func:`crossing_spans` counts the rows a
pointer leaves to the fix-up's second level.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from ... import resolve_device
from ...utils import debug
from ..sparse import PRECISIONS

if TYPE_CHECKING:
    from ...graph import BipartiteGraph

# Run lengths (CSR slots a warp sums) of csr_spmm_f32 and seg_reduce_f32,
# and the runs that fill the card: 132 SMs x 32 warps.
RUN_SLOTS = (32, 64, 128, 256)
RUNS_TARGET = 132 * 32
RUN_D1 = 32     # at d = 1 a thread takes a run
# Slots a warp of csr_spmm_dw_f32 by default (PERF.md, the sweep of run
# lengths and groups of lanes at the linkpred shapes).
DW_RUN = 128
# The fix-up of the rows that cross runs (csrc/runs.cuh): a block of
# FIX_THREADS threads a chunk of runs, each worker (a thread at d = 1, a
# warp above) FIX_PER_D1 / FIX_PER consecutive runs (PERF.md, the sweep).
# The kernels hold the same numbers (csr_fix_chunk_runs).
FIX_THREADS = 256
FIX_PER_D1 = 2
FIX_PER = 8
# cross[k] besides a row: no row leaves run k across its end, or run k's
# one piece continues a row past it (runs::kClosed, runs::kThrough)
CLOSED, THROUGH = -1, -2

# Launches of csr_spmm_f32, seg_reduce_f32, csr_spmm_dw_f32, csr_spmm_bf16
# and csr_spmm_dw_bf16 in this process (plain counts, reset by callers that
# measure a run).
launches = 0
seg_launches = 0
dw_launches = 0
bf16_launches = 0
dw_bf16_launches = 0

# The row types of the kernels: float32 and the bfloat16 payload.
ROW_TYPES = (torch.float32, torch.bfloat16)

_lib: Optional[ctypes.CDLL] = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("spmm")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.csr_spmm_f32.argtypes = [p] * 6 + [i] * 4 + [p]
        lib.seg_reduce_f32.argtypes = [p] * 4 + [i] * 4 + [p]
        lib.csr_spmm_dw_f32.argtypes = [p] * 9 + [i] * 5 + [p]
        lib.csr_spmm_bf16.argtypes = lib.csr_spmm_f32.argtypes
        lib.csr_spmm_dw_bf16.argtypes = lib.csr_spmm_dw_f32.argtypes
        for fn in (lib.csr_spmm_f32, lib.seg_reduce_f32, lib.csr_spmm_dw_f32,
                   lib.csr_spmm_bf16, lib.csr_spmm_dw_bf16):
            fn.restype = ctypes.c_int
        lib.csr_fix_chunk_runs.argtypes = [i]
        lib.csr_fix_chunk_runs.restype = ctypes.c_int
        lib.csr_spmm_error_string.argtypes = [ctypes.c_int]
        lib.csr_spmm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def widen(rows: torch.Tensor) -> torch.Tensor:
    """Rows as the kernels compute with them: bfloat16 widened to float32,
    any other type as it is."""
    return rows.float() if rows.dtype == torch.bfloat16 else rows


def edge_rows(ptr: torch.Tensor, n_edges: int) -> torch.Tensor:
    """The row of each of the first ``n_edges`` CSR slots (int64)."""
    return torch.repeat_interleave(
        torch.arange(ptr.numel() - 1, device=ptr.device),
        (ptr[1:] - ptr[:-1]).long(), output_size=n_edges)


def csr_spmm_plain(ptr: torch.Tensor, col: torch.Tensor,
                   w: Optional[torch.Tensor], x: torch.Tensor,
                   n_rows: int) -> torch.Tensor:
    """Plain version: gather the rows (widened to float32), scale,
    ``index_add_`` into rows."""
    rows = edge_rows(ptr, col.numel())
    vals = widen(x[col.long()])
    out = vals.new_zeros((n_rows, x.shape[1]))
    return out.index_add_(0, rows, vals if w is None else w[:, None] * vals)


def warp_run(n_slots: int) -> int:
    """Run length of a walk with a warp per run over ``n_slots`` CSR
    slots: the shortest of :data:`RUN_SLOTS` whose runs do not outnumber
    :data:`RUNS_TARGET` warps (a longer run adds rounds of loads a warp, a
    shorter one more partials to add up)."""
    for run in RUN_SLOTS:
        if -(-n_slots // run) <= RUNS_TARGET:
            return run
    return RUN_SLOTS[-1]


def run_for(n_slots: int, d: int) -> int:
    """Run length of ``csr_spmm_f32`` / ``seg_reduce_f32`` for ``n_slots``
    CSR slots of width ``d``: :func:`warp_run`, or :data:`RUN_D1` slots a
    thread at ``d = 1``."""
    return RUN_D1 if d == 1 else warp_run(n_slots)


def n_runs(n_slots: int, run: int) -> int:
    """Runs of ``run`` slots over ``n_slots`` (at least one)."""
    return max(1, -(-n_slots // run))


def fix_shape(d: int):
    """``(workers, runs a worker)`` of the fix-up's first level at width
    ``d``: threads at ``d = 1``, warps above."""
    if d == 1:
        return FIX_THREADS, FIX_PER_D1
    return FIX_THREADS // 32, FIX_PER


def chunk_runs(d: int) -> int:
    """Runs a chunk of the fix-up's first level at width ``d``."""
    workers, per = fix_shape(d)
    return workers * per


def sums_ws_floats(n_slots: int, run: int, d: int) -> int:
    """Floats of the workspace of a walk that sums rows of width ``d`` over
    runs of ``run`` of ``n_slots`` slots (``csr_spmm_f32``,
    ``seg_reduce_f32``, ``csr_spmm_dw_f32``'s dx, ``r1_bwd_f32``'s dc at
    ``d = 1``): the runs' head and tail partials ``[n_runs, d]`` each and
    ``cross`` (int32), then the same for the fix-up's chunks of
    :func:`chunk_runs` runs."""
    n = n_runs(n_slots, run)
    return (n + -(-n // chunk_runs(d))) * (2 * d + 1)


def crossing_spans(ptr: np.ndarray, run: int, chunk: int):
    """``(long_crossings, longest_crossing_runs)`` of a CSR pointer summed
    over runs of ``run`` slots and fix-up chunks of ``chunk`` runs: the
    rows whose partials span more runs than a chunk holds (a hub's rows,
    which only the fix-up's second level can add up) and the most runs one
    row's partials span (0 when no row crosses a run)."""
    ptr = np.asarray(ptr, np.int64)
    begin, end = ptr[:-1], ptr[1:]
    spans = ((end - 1) // run - begin // run + 1)[end > begin]
    spans = spans[spans > 1]
    return int((spans > chunk).sum()), int(spans.max(initial=0))


def cross_code(pl, row: int, first: int, last: int) -> int:
    """``runs::cross_code``: ``cross[k]`` of the run ``[first, last)`` whose
    last row piece is ``row``'s (``pl`` the pointer as a list)."""
    if pl[row + 1] <= last:
        return CLOSED
    return THROUGH if pl[row] < first else row


def _join(left, right, put):
    """``runs::join``: the stretch ``left`` followed by ``right``, each
    ``(x, e, t)``; writes the row that ``left`` lets out and ``right``
    ends through ``put(row, value)``."""
    x, e, t = left
    xr, er, tr = right
    if x == THROUGH:
        return xr, e + er, tr
    if x >= 0:
        if xr == THROUGH:
            return x, e, t + er
        put(x, t + er)
    return xr, e, tr


def fixup_runs_plain(pl, head, tail, cross, run: int, put, fix):
    """The fix-up grids of ``csrc/runs.cuh`` in plain Python, in the
    kernels' order of additions: the runs that hold edges cut into chunks of
    ``workers * per`` runs (``fix``); in each, every worker joins its
    ``per`` runs left to right, then the workers' stretches are joined in a
    binary tree (worker ``w`` takes in ``w + s`` at step ``s``); a row that
    leaves its chunk is added over the chunks' partials at level 2.  ``pl``
    the pointer as a list; ``head``, ``tail`` the runs' partials (``None``
    where a run left none: the kernels' workspace holds stale floats there,
    which the fix-up must not read, and a read of ``None`` fails);
    ``cross`` the runs' codes.  Returns ``(long_crossings,
    longest_crossing_runs)`` as the rows were added (:func:`crossing_spans`
    counts them from the pointer): the rows written at level 2 whose
    partials span more runs than a chunk holds, and the most runs one
    crossing row's partials span."""
    workers, per = fix
    chunk = workers * per
    held = -(-pl[-1] // run)
    chunks = []
    for c in range(-(-held // chunk)):
        stretches = []
        for w in range(workers):
            j0 = c * chunk + w * per
            s = (CLOSED, 0.0, 0.0)   # an idle worker
            for j in range(j0, min(j0 + per, held)):
                leaf = (cross[j], head[j], tail[j])
                s = leaf if j == j0 else _join(s, leaf, put)
            stretches.append(s)
        step = 1
        while step < workers:
            for w in range(0, workers, 2 * step):
                stretches[w] = _join(stretches[w], stretches[w + step], put)
            step *= 2
        chunks.append(stretches[0])
    long = 0
    for c, (x, _, t) in enumerate(chunks):
        if x < 0:
            continue
        v = t
        for j in range(c + 1, (pl[x + 1] - 1) // (run * chunk) + 1):
            v = v + chunks[j][1]
        put(x, v)
        long += (pl[x + 1] - 1) // run - pl[x] // run + 1 > chunk
    spans = [(pl[r + 1] - 1) // run - k + 1
             for k, r in enumerate(cross[:held]) if r >= 0]
    return long, max(spans, default=0)


def csr_spmm_runs_plain(ptr: torch.Tensor, col: Optional[torch.Tensor],
                        w: Optional[torch.Tensor], x: torch.Tensor,
                        n_rows: int, run: int, fix=None,
                        spans: Optional[dict] = None):
    """The schedule of ``csr_spmm_f32`` and ``seg_reduce_f32`` in plain
    PyTorch, step by step as the kernels take it (``msha_gnn_torch/csrc/
    runs.cuh``): each run of ``run`` consecutive slots sums its pieces of
    rows, writing a row that lies inside it and leaving the head and tail
    partials of rows that cross its ends and its cross code; empty rows
    are zeroed by the run that holds their slot; then the crossing rows are
    added up by :func:`fixup_runs_plain` (``fix``: its ``(workers, runs a
    worker)``, default :func:`fix_shape`).  ``col`` None: the identity
    (``seg_reduce_f32``).  ``spans``, a dict, receives the fix-up's
    ``long_crossings`` and ``longest_crossing_runs``.

    Returns ``(out [n_rows, d], writes [n_rows])``, ``writes`` counting how
    often each row was written (the kernels write each row once).  Slow: a
    Python loop over the runs, for tests.
    """
    pl = [int(v) for v in ptr.tolist()]
    n_edges, d = pl[n_rows], x.shape[1]
    idx = (torch.arange(n_edges, device=x.device) if col is None
           else col[:n_edges].long())
    vals = x[idx] if w is None else w[:n_edges, None] * x[idx]
    rows = edge_rows(ptr, n_edges)
    out = x.new_full((n_rows, d), float("nan"))
    writes = torch.zeros(n_rows, dtype=torch.int64)
    n = n_runs(n_edges, run)
    head, tail, cross = [None] * n, [None] * n, [CLOSED] * n

    def put(r, v):
        out[r] = v
        writes[r] += 1

    if n_edges == 0:
        for r in range(n_rows):
            put(r, 0.0)
    for k in range(n):
        first, last = k * run, min(k * run + run, n_edges)
        if first >= n_edges:
            break
        r0 = int(rows[first])
        r = r0
        while r > 0 and pl[r - 1] == first:
            r -= 1
        for empty in range(r, r0):
            put(empty, 0.0)
        piece_rows, counts = torch.unique_consecutive(rows[first:last],
                                                      return_counts=True)
        local = torch.repeat_interleave(torch.arange(len(counts)), counts)
        sums = x.new_zeros((len(counts), d)).index_add_(0, local,
                                                        vals[first:last])
        prev = None
        for rr, s in zip(piece_rows.tolist(), sums):
            if prev is not None:
                for empty in range(prev + 1, rr):
                    put(empty, 0.0)
            begin, end = pl[rr], pl[rr + 1]
            if begin < first:
                head[k] = s
            elif end > last:
                tail[k] = s
            else:
                put(rr, s)
            prev = rr
        cross[k] = cross_code(pl, prev, first, last)
        if last == n_edges:
            for empty in range(prev + 1, n_rows):
                put(empty, 0.0)
    long, longest = fixup_runs_plain(pl, head, tail, cross, run, put,
                                     fix or fix_shape(d))
    if spans is not None:
        spans.update(long_crossings=long, longest_crossing_runs=longest)
    return out, writes


def csr_spmm(ptr: torch.Tensor, col: torch.Tensor, w: Optional[torch.Tensor],
             x: torch.Tensor, n_rows: int,
             run: Optional[int] = None) -> torch.Tensor:
    """``out[r] = sum_{e in row r} w[e] * x[col[e]]`` -> [n_rows, d] f32.

    ``ptr`` int32 [n_rows + 1], ``col`` int32 [E], ``w`` f32 [E] or None
    for unit weights, ``x`` [n_cols, d] float32 (``csr_spmm_f32``) or
    bfloat16 (``csr_spmm_bf16``: the rows widened in registers, the sums
    in float32), all contiguous and on one device; ``run`` slots a warp
    (default :func:`run_for`).  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise.
    """
    global launches, bf16_launches
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
    if x.dtype not in ROW_TYPES or (w is not None
                                    and w.dtype != torch.float32):
        raise TypeError(f"x must be float32 or bfloat16 and w float32, got "
                        f"{x.dtype}, {None if w is None else w.dtype}")
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
    d, n_slots = x.shape[1], col.numel()
    out = torch.empty((n_rows, d), dtype=torch.float32, device=dev)
    if n_rows == 0 or d == 0:
        return out
    run = run_for(n_slots, d) if run is None else int(run)
    ws = torch.empty(sums_ws_floats(n_slots, run, d), dtype=torch.float32,
                     device=dev)
    lib = _kernel_lib()
    bf16 = x.dtype == torch.bfloat16
    name = "csr_spmm_bf16" if bf16 else "csr_spmm_f32"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, name)(ptr.data_ptr(), col.data_ptr(),
                                None if w is None else w.data_ptr(),
                                x.data_ptr(), out.data_ptr(), ws.data_ptr(),
                                n_rows, n_slots, run, d, stream)
    _raise_on(lib, rc, name)
    debug.check_kernel(name, out)
    if bf16:
        bf16_launches += 1
    else:
        launches += 1
    return out


# csr_spmm as the operator torch.ops.msha_gnn_torch.csr_spmm, so that
# torch.export records the kernel (csr_spmm_f32, or csr_spmm_bf16 for
# bfloat16 rows) as one node of a graph (it cannot trace a ctypes call).
# Registered through torch.library.Library, not torch.library.custom_op:
# custom_op runs each kernel under torch._dynamo.disable, whose first call
# imports torch._dynamo (7.84 s in a fresh interpreter on an H100 machine)
# and which adds 17-27 us a call there (PERF.md).  Which registration runs
# follows the tensors' device: csr_spmm on CUDA ones (the kernel, counted
# in launches / bf16_launches), csr_spmm_plain on CPU ones, none on any
# other.  The operator has no autograd formula (SpmmOperator's _SpmmFn
# differentiates the SpMM).
_LIB = torch.library.Library("msha_gnn_torch", "DEF")
_LIB.define("csr_spmm(Tensor ptr, Tensor col, Tensor? w, Tensor x, "
            "int n_rows) -> Tensor")
_LIB.impl("csr_spmm", csr_spmm, "CUDA")
_LIB.impl("csr_spmm", csr_spmm_plain, "CPU")


@torch.library.register_fake("msha_gnn_torch::csr_spmm")
def _csr_spmm_fake(ptr, col, w, x, n_rows):
    return x.new_empty((n_rows, x.shape[1]), dtype=torch.float32)


csr_spmm_op = torch.ops.msha_gnn_torch.csr_spmm


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.csr_spmm_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (error {rc})")


def _on_card(dev, kernel: str, given, ints=("ptr", "col", "eid"),
             rows=(), row_type=torch.float32) -> None:
    """Raises unless every tensor of ``given`` lies on the CUDA device
    ``dev``, contiguous, int32 (the names in ``ints``), ``row_type`` (the
    names in ``rows``) or float32."""
    if dev.type != "cuda":
        raise ValueError(f"{kernel} runs on cuda or cpu, not {dev}")
    for name, t in given:
        want = (torch.int32 if name in ints
                else row_type if name in rows else torch.float32)
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# ---------------------------------------------------------------------------
# The sorted segment sum (seg_reduce_f32)
# ---------------------------------------------------------------------------

def segment_reduce_sorted_plain(values: torch.Tensor, senders: torch.Tensor,
                                row_ptr: torch.Tensor, *,
                                n_src: int) -> torch.Tensor:
    """Plain version of :func:`segment_reduce_sorted`: ``index_add_`` of
    the rows ``[0, row_ptr[n_src])`` into the row each lies in."""
    e = int(row_ptr[n_src])
    out = values.new_zeros((n_src, values.shape[1]))
    return out.index_add_(0, edge_rows(row_ptr, e), values[:e])


def segment_reduce_sorted(values: torch.Tensor, senders: torch.Tensor,
                          row_ptr: torch.Tensor, *, n_src: int,
                          run: Optional[int] = None) -> torch.Tensor:
    """``out[s] = sum_{e: senders[e] == s} values[e]`` -> [n_src, d] f32,
    for ``values`` [E_pad, d] f32 sorted by segment, ``senders`` [E_pad]
    (pads ``>= n_src``) and ``row_ptr`` [n_src + 1] their CSR offsets.

    The contract of ``segment_sum`` on sorted ids; the kernel walks
    ``row_ptr`` (``senders`` is taken for the JAX signature and must agree
    with it) and reads no row past ``row_ptr[n_src]``.  CPU tensors take
    :func:`segment_reduce_sorted_plain`; CUDA tensors launch
    ``seg_reduce_f32`` or raise.  Its runs (``run`` slots each, default
    :func:`run_for`) cover ``values``' rows, a bound the host has: the
    number of edges is read from ``row_ptr`` on the card, so a long row
    needs no host-side look at the pointer.
    """
    if senders.shape != values.shape[:1]:
        raise ValueError(f"shapes: senders {tuple(senders.shape)} for "
                         f"values {tuple(values.shape)}")
    return row_sums(values, row_ptr, n_rows=n_src, run=run)


def row_sums(values: torch.Tensor, row_ptr: torch.Tensor, *, n_rows: int,
             run: Optional[int] = None) -> torch.Tensor:
    """``out[r] = sum_{e in [row_ptr[r], row_ptr[r + 1])} values[e]`` ->
    [n_rows, d] f32 for ``values`` [E_pad, d] f32 in CSR order (rows past
    ``row_ptr[n_rows]`` are never read): :func:`segment_reduce_sorted`
    without the senders.  One ``seg_reduce_f32`` launch on CUDA tensors
    (counted in :data:`seg_launches`), the plain version on the CPU."""
    global seg_launches
    if values.dim() != 2 or row_ptr.shape != (n_rows + 1,):
        raise ValueError(f"shapes: values {tuple(values.shape)}, row_ptr "
                         f"{tuple(row_ptr.shape)} for {n_rows} segments")
    dev = values.device
    if dev.type == "cpu":
        return segment_reduce_sorted_plain(values, None, row_ptr,
                                           n_src=n_rows)
    ptr = row_ptr.to(torch.int32).contiguous()
    _on_card(dev, "segment_reduce_sorted", (("row_ptr", ptr),
                                             ("values", values)),
             ints=("row_ptr",))
    n_slots, d = values.shape
    out = torch.empty((n_rows, d), dtype=torch.float32, device=dev)
    if n_rows == 0 or d == 0:
        return out
    run = run_for(n_slots, d) if run is None else int(run)
    ws = torch.empty(sums_ws_floats(n_slots, run, d), dtype=torch.float32,
                     device=dev)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.seg_reduce_f32(ptr.data_ptr(), values.data_ptr(),
                                out.data_ptr(), ws.data_ptr(), n_rows,
                                n_slots, run, d, stream)
    _raise_on(lib, rc, "seg_reduce_f32")
    debug.check_kernel("seg_reduce_f32", out)
    seg_launches += 1
    return out


# ---------------------------------------------------------------------------
# The weighted SpMM's backward in one pass (csr_spmm_dw_f32)
# ---------------------------------------------------------------------------

def csr_spmm_dw_plain(ptr, col, eid, w, g, x, n_rows: int, n_dw: int):
    """Plain version of :func:`csr_spmm_dw`: gather (the rows widened to
    float32), ``index_add_``, and the per-edge dots scattered to their
    ids."""
    e = col.numel()
    rows = edge_rows(ptr, e)
    ids = torch.arange(e, device=g.device) if eid is None else eid.long()
    gg = widen(g[col.long()])
    dx = gg.new_zeros((n_rows, g.shape[1])).index_add_(
        0, rows, w[ids][:, None] * gg)
    dw = gg.new_zeros(n_dw)
    dw[ids] = (gg * widen(x[rows])).sum(1)
    return dx, dw


def csr_spmm_dw_runs_plain(ptr, col, eid, w, g, x, n_rows: int, n_dw: int,
                           run: int, group: int, fix=None):
    """The walk of ``csr_spmm_dw_f32`` (``csrc/gat_bwd.cuh``, the source
    ``kDw``) in plain PyTorch, step by step as the kernel takes it
    (``rank1_gat._edge_walk``): runs of ``run`` slots of ``[0, n_dw)``, each
    zeroing its pads past ``ptr[n_rows]`` (dw's slots, by slot), handing
    the edges of each row piece to ``32 / group`` groups (each edge's dot
    stored at its id, its ``w g`` row added to the piece), writing a row
    that lies inside the run and leaving the head and tail partials of
    rows that cross its ends and its cross code, empty rows zeroed by the
    run that owns them; then the crossing rows are added up by
    :func:`fixup_runs_plain` (``fix`` as there).

    Returns ``(dx [n_rows, d], dw [n_dw], dx_writes, dw_writes)``, the
    writes counting how often each row of dx and slot of dw was written
    (the kernel writes each once).  Slow: Python loops over runs and
    steps, for tests."""
    from .rank1_gat import _edge_walk

    pl = [int(v) for v in ptr.tolist()]
    n_edges, d = pl[n_rows], g.shape[1]
    ids = (torch.arange(n_edges) if eid is None
           else eid[:n_edges].long())
    dx = g.new_full((n_rows, d), float("nan"))
    dw = g.new_full((n_dw,), float("nan"))
    dx_writes = torch.zeros(n_rows, dtype=torch.int64)
    dw_writes = torch.zeros(n_dw, dtype=torch.int64)
    n = n_runs(n_dw, run)
    head, tail, cross = [None] * n, [None] * n, [CLOSED] * n
    piece = g.new_zeros(d)

    def put(r, v):
        dx[r] = v
        dx_writes[r] += 1

    for event, *at in _edge_walk(ptr, n_dw, run, group, d):
        if event == "pads":
            dw[at[0]] = 0.0
            dw_writes[at[0]] += 1
        elif event == "empty":
            put(at[0], 0.0)
        elif event == "step":
            row, idx = at
            gg, slot = g[col[idx].long()], ids[idx]
            dw[slot] = (gg * x[row]).sum(1)
            dw_writes.index_add_(0, slot, torch.ones_like(slot))
            piece = piece + (w[slot][:, None] * gg).sum(0)
        else:
            k, row, target = at
            if target == "head":
                head[k] = piece
            elif target == "tail":
                tail[k] = piece
            else:
                put(row, piece)
            cross[k] = cross_code(pl, row, k * run,
                                  min(k * run + run, n_edges))
            piece = g.new_zeros(d)
    fixup_runs_plain(pl, head, tail, cross, run, put, fix or fix_shape(d))
    return dx, dw, dx_writes, dw_writes


def csr_spmm_dw(ptr, col, eid, w, g, x, n_rows: int, n_dw: int,
                ws: Optional[torch.Tensor] = None, run: Optional[int] = None,
                group: Optional[int] = None):
    """A weighted SpMM's backward in one pass -> ``(dx [n_rows, d], dw
    [n_dw])`` f32::

        dx[r]    = sum_{e in row r} w[id_e] * g[col[e]]
        dw[id_e] = <g[col[e]], x[r]>,   id_e = eid[e] (e when eid is None)

    with ``dw``'s other slots 0.  ``ptr`` int32 [n_rows + 1], ``col`` and
    ``eid`` int32 [E], ``w`` f32 indexed by ``id_e``, ``g`` [n_cols, d] and
    ``x`` [n_rows, d] both float32 (``csr_spmm_dw_f32``) or both bfloat16
    (``csr_spmm_dw_bf16``: the rows widened in registers, the dots and
    sums in float32; ``dx`` and ``dw`` float32).  ``ws`` the kernel's
    workspace (at least
    :func:`sums_ws_floats` float32; allocated when None), ``run`` slots a
    warp (default :data:`DW_RUN`), ``group`` lanes an edge (one of
    ``rank1_gat.GROUPS``, default ``rank1_gat.group_for``).  CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise.
    """
    global dw_launches, dw_bf16_launches
    dev = g.device
    if dev.type == "cpu":
        return csr_spmm_dw_plain(ptr, col, eid, w, g, x, n_rows, n_dw)
    from .rank1_gat import _group

    given = [("ptr", ptr), ("col", col), ("w", w), ("g", g), ("x", x)]
    if eid is not None:
        given.append(("eid", eid))
    row_type = g.dtype if g.dtype in ROW_TYPES else torch.float32
    _on_card(dev, "csr_spmm_dw", given, rows=("g", "x"), row_type=row_type)
    d = g.shape[1] if g.dim() == 2 else -1
    if (g.dim() != 2 or x.shape != (n_rows, d) or ptr.shape != (n_rows + 1,)
            or col.dim() != 1 or n_dw < col.numel()
            or (eid is not None and eid.shape != col.shape)):
        raise ValueError(
            f"shapes: ptr {tuple(ptr.shape)} for {n_rows} rows, col "
            f"{tuple(col.shape)}, g {tuple(g.shape)}, x {tuple(x.shape)}, "
            f"n_dw {n_dw}")
    run = DW_RUN if run is None else int(run)
    group = _group(group, d)
    need = sums_ws_floats(n_dw, run, d)
    if ws is None:
        ws = torch.empty(need, dtype=torch.float32, device=dev)
    elif (ws.device != dev or ws.dtype != torch.float32
          or not ws.is_contiguous() or ws.numel() < need):
        raise ValueError(f"ws must be {need} contiguous float32 on {dev}")
    dx = torch.empty((n_rows, d), dtype=torch.float32, device=dev)
    dw = torch.empty(n_dw, dtype=torch.float32, device=dev)
    if n_rows == 0:
        return dx, dw.zero_()
    lib = _kernel_lib()
    bf16 = row_type == torch.bfloat16
    name = "csr_spmm_dw_bf16" if bf16 else "csr_spmm_dw_f32"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, name)(
            ptr.data_ptr(), col.data_ptr(),
            None if eid is None else eid.data_ptr(), w.data_ptr(),
            g.data_ptr(), x.data_ptr(), dx.data_ptr(), dw.data_ptr(),
            ws.data_ptr(), n_rows, n_dw, run, group, d, stream)
    _raise_on(lib, rc, name)
    debug.check_kernel(name, dx, dw)
    if bf16:
        dw_bf16_launches += 1
    else:
        dw_launches += 1
    return dx, dw


class SpmmOperator:
    """``A @ x`` and ``A.T @ x`` for one graph, on one device.

    ``launches`` counts this operator's ``csr_spmm_f32`` launches,
    ``launches_transposed`` those of them that ran ``A.T`` and
    ``launches_reduce`` those of :meth:`reduce_edges` (transposed too).
    ``fused_bwd``: a runtime edge weight's gradient and ``dx`` come from
    one ``csr_spmm_dw_f32`` launch (``spmm.py::SpmmOperator``'s flag of
    the same name), not from ``csr_spmm_f32`` and ``csr_sddmm_f32``; on the
    card the operator holds its workspace for all its calls, which run in
    order on the current stream.  ``precision="bf16"``: the rows are
    streamed in bfloat16 (``csr_spmm_bf16``, ``csr_spmm_dw_bf16``), the
    arithmetic is float32 (the module's docstring).
    """

    def __init__(self, graph: "BipartiteGraph", device="cuda",
                 fused_bwd: bool = False, precision: str = "f32",
                 host: Optional["BipartiteGraph"] = None):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r} (f32 | bf16)")
        self.device = resolve_device(device)
        self.graph = graph
        self.fused_bwd = bool(fused_bwd)
        self.precision = precision
        # the arrays are sorted on the host: read them from ``host``, the
        # same graph on the CPU, when the caller has it
        src = graph if host is None else host
        e = src.num_edges
        if e != graph.num_edges or src.n_src != graph.n_src \
                or src.n_dst != graph.n_dst:
            raise ValueError("host is not the same graph")
        if e >= 2**31:
            raise ValueError(f"{e} edges overflow the kernel's int32 offsets")
        s = src.senders[:e].cpu().numpy()
        r = src.receivers[:e].cpu().numpy()
        w = src.weight[:e].cpu().numpy().astype(np.float32)
        # CSC: the same edges sorted by (receiver, sender)
        order = np.lexsort((s, r))
        csc_ptr = np.zeros(graph.n_dst + 1, np.int64)
        csc_ptr[1:] = np.bincount(r, minlength=graph.n_dst)
        dev = self.device

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        self.ptr = put(src.row_ptr.cpu().numpy(), np.int32)
        self.col = put(r, np.int32)
        self.w = put(w, np.float32)
        self.t_ptr = put(np.cumsum(csc_ptr), np.int32)
        self.t_col = put(s[order], np.int32)
        self.t_w = put(w[order], np.float32)
        self.t_edge = put(order, np.int32)  # CSC position -> CSR edge id
        self.num_edges = e
        self._dw_ws: Optional[torch.Tensor] = None
        self.launches = 0
        self.launches_transposed = 0
        self.launches_reduce = 0

    @staticmethod
    def build(graph: "BipartiteGraph", fused_bwd: bool = False,
              precision: str = "f32",
              host: Optional["BipartiteGraph"] = None) -> "SpmmOperator":
        """The operator of ``graph`` on the graph's device (its arrays read
        from ``host`` when given)."""
        return SpmmOperator(graph, graph.device, fused_bwd, precision, host)

    def _launch(self, ptr, col, w, x, n_out, transpose):
        before = launches + bf16_launches
        out = csr_spmm_op(ptr, col, w, x, n_out)
        if launches + bf16_launches != before:
            self.launches += 1
            self.launches_transposed += int(transpose)
        return out

    def weights(self, edge_weight: Optional[torch.Tensor],
                transpose: bool) -> torch.Tensor:
        """The weights of one direction's edges: the CSR-order
        ``edge_weight`` (or the graph's own, for None) cut to the real
        edges, or permuted to CSC order when ``transpose``."""
        if edge_weight is None:
            return self.t_w if transpose else self.w
        if transpose:
            return edge_weight[self.t_edge].contiguous()
        return edge_weight[: self.num_edges].contiguous()

    def apply(self, x: torch.Tensor, edge_weight: Optional[torch.Tensor],
              transpose: bool) -> torch.Tensor:
        """``A @ x`` (``A.T @ x`` when ``transpose``) for the CSR-order
        ``edge_weight`` (None: the graph's own); no autograd."""
        g, w = self.graph, self.weights(edge_weight, transpose)
        if transpose:
            return self._launch(self.t_ptr, self.t_col, w, x, g.n_dst, True)
        return self._launch(self.ptr, self.col, w, x, g.n_src, False)

    def backward_dw(self, g: torch.Tensor, x: torch.Tensor,
                    edge_weight: torch.Tensor, transpose: bool):
        """``(dx, dw)`` of ``A(w) @ x`` (``A(w).T @ x`` when ``transpose``)
        for the cotangent ``g`` and the CSR-order ``edge_weight`` [E_pad], by
        one ``csr_spmm_dw_f32`` launch (``csr_spmm_dw_bf16`` for bfloat16
        ``g`` and ``x``): the dx direction's walk, whose rows are ``x``'s
        own.  For ``A @ x`` that is the CSC, and ``dw`` lands in
        CSR order through ``t_edge``; for ``A.T @ x`` the CSR itself."""
        gr, n_dw = self.graph, edge_weight.shape[0]
        ws = None
        if self.device.type == "cuda":
            need = sums_ws_floats(n_dw, DW_RUN, g.shape[1])
            if self._dw_ws is None or self._dw_ws.numel() < need:
                self._dw_ws = torch.empty(need, dtype=torch.float32,
                                          device=self.device)
            ws = self._dw_ws
        if transpose:
            return csr_spmm_dw(self.ptr, self.col, None, edge_weight, g, x,
                               gr.n_src, n_dw, ws)
        return csr_spmm_dw(self.t_ptr, self.t_col, self.t_edge, edge_weight,
                           g, x, gr.n_dst, n_dw, ws)

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
        if edge_weight is not None and (
                edge_weight.dim() != 1 or edge_weight.shape[0] < self.num_edges
                or edge_weight.device != self.device):
            raise ValueError(f"edge_weight must be [>= {self.num_edges}] on "
                             f"{self.device}, got {tuple(edge_weight.shape)} "
                             f"on {edge_weight.device}")
        return _SpmmFn.apply(x, edge_weight, self, transpose)

    def reduce_edges(self, z: torch.Tensor) -> torch.Tensor:
        """``out[j] = sum_{e: rcv_e = j} z[e]`` -> [n_dst, d], for ``z``
        [num_edges, d] in CSR edge order; one transposed kernel launch."""
        if z.device != self.device:
            raise ValueError(f"z is on {z.device}, the operator on "
                             f"{self.device}")
        if z.dim() != 2 or z.shape[0] != self.num_edges:
            raise ValueError(f"z must be [{self.num_edges}, d], got "
                             f"{tuple(z.shape)}")
        before = self.launches
        out = self._launch(self.t_ptr, self.t_edge, None, z.contiguous(),
                           self.graph.n_dst, True)
        self.launches_reduce += self.launches - before
        return out


class _SpmmFn(torch.autograd.Function):
    """``A @ x`` with ``dx = A.T @ g``, and ``A.T @ x`` with ``dx = A @ g``:
    the backward is the other direction's launch of the same kernel.  A
    runtime edge weight (``edge_weight`` [E_pad], CSR order, or None for
    the graph's own) gets ``dw`` [E_pad] from one ``csr_sddmm_f32`` launch
    over the CSR direction, pads 0; with the operator's ``fused_bwd``, one
    ``csr_spmm_dw_f32`` launch gives ``dx`` and ``dw`` together.  With the
    operator's ``precision="bf16"``, ``x`` and the cotangent go to the
    kernels as bfloat16 copies (``dw``'s SDDMM takes them widened)."""

    @staticmethod
    def forward(ctx, x, edge_weight, op, transpose):
        ctx.op, ctx.transpose = op, transpose
        if op.precision == "bf16":
            x = x.to(torch.bfloat16)
        ctx.save_for_backward(x, edge_weight)
        return op.apply(x, edge_weight, transpose)

    @staticmethod
    def backward(ctx, g):
        x, edge_weight = ctx.saved_tensors
        op, g = ctx.op, g.contiguous().to(x.dtype)
        dx = dw = None
        if op.fused_bwd and ctx.needs_input_grad[1]:
            dx, dw = op.backward_dw(g, x, edge_weight.contiguous(),
                                    ctx.transpose)
            return (dx if ctx.needs_input_grad[0] else None), dw, None, None
        if ctx.needs_input_grad[0]:
            dx = op.apply(g, edge_weight, not ctx.transpose)
        if ctx.needs_input_grad[1]:
            from .sddmm import csr_sddmm

            # rows of the CSR direction are A's rows: g's for A @ x, x's
            # for A.T @ x
            rows, cols = (x, g) if ctx.transpose else (g, x)
            dw = csr_sddmm(op.ptr, op.col, widen(rows), widen(cols),
                           edge_weight.shape[0])
        return dx, dw, None, None


# One operator per graph and kind, so repeated layer calls share the build
# (host-side sorts and copies to the device).
_OPS: dict = {}


def cached_for(graph: "BipartiteGraph", build, host=None):
    """``build(graph)`` (``build(graph, host=host)`` with ``host``, the same
    graph on the CPU), made once per graph and builder (the last 16)."""
    key = (id(graph), build)
    entry = _OPS.get(key)
    if entry is None or entry[0] is not graph:
        entry = (graph, build(graph) if host is None
                 else build(graph, host=host))
        _OPS[key] = entry
        if len(_OPS) > 16:
            _OPS.pop(next(iter(_OPS)))
    return entry[1]


def release(graph: "BipartiteGraph") -> None:
    """Drop every cached operator of ``graph`` (a per-epoch subgraph, at
    its epoch's end), so its device arrays go with the graph."""
    for key in [k for k, entry in _OPS.items() if entry[0] is graph]:
        del _OPS[key]


def _build_bf16(graph: "BipartiteGraph", host=None) -> SpmmOperator:
    return SpmmOperator.build(graph, precision="bf16", host=host)


def operator_for(graph: "BipartiteGraph", precision: str = "f32",
                 host: Optional["BipartiteGraph"] = None) -> SpmmOperator:
    """The cached :class:`SpmmOperator` of ``graph`` at ``precision``, on
    the graph's device; a first build reads the arrays from ``host`` when
    given (the same graph on the CPU: no copy back from the card)."""
    return cached_for(graph, _build_bf16 if precision == "bf16"
                      else SpmmOperator.build, host)


def spmm_cuda(graph: "BipartiteGraph", x: torch.Tensor, *,
              edge_weight: Optional[torch.Tensor] = None,
              transpose: bool = False,
              precision: str = "f32") -> torch.Tensor:
    """``spmm(..., impl="cuda")``: the graph's operator at ``precision``
    applied to ``x``."""
    return operator_for(graph, precision)(x, edge_weight=edge_weight,
                                          transpose=transpose)
