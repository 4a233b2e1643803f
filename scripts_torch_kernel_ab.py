"""The CSR-sum, GAT, SDDMM and row-softmax kernels of two ``csrc`` trees
side by side on one CUDA card: each tree's build, called through its own C
signatures, on the same inputs.

    python3 scripts_torch_kernel_ab.py BASE_CSRC

``BASE_CSRC`` is another tree's ``msha_gnn_torch/csrc`` (for example the
parent commit's, unpacked with ``git archive`` into a directory that
``.gitignore`` lists), whose ``csr_spmm_dw_f32`` (``spmm.cu``) runs one
block per row, ``csr_spmm_dw_f32(ptr, col, eid, w, g, x, dx, dw, n_rows,
n_dw, d, n_warps, stream)`` with ``n_warps`` as its operator chose them
from the row lengths (``base_dw_warps``), whose row softmax entries
(``softmax.cu``) take no dropout, ``seg_softmax_fwd_f32(ptr, logits, mask,
att, lse, ws, n_rows, n_edges, n_slots, run, stream)`` and
``seg_softmax_bwd_f32(ptr, att, g, dl, ws, n_rows, n_edges, n_slots, run,
stream)``, and whose ``rank1_gat.cu`` has the keep-mask kernel
``r1l_keep_scale_f32(seed, rate, scale, n, out, stream)``.  This tree's
``csr_spmm_dw_f32`` is the edge-run walk of ``csrc/gat_bwd.cuh`` (a
workspace, the run length and the lanes an edge), and its softmax entries
take a seed, folding the keep mask into the walk.  Those entries are
called through each build's C entries (into preallocated workspaces, as
the operators hold them), so that the event times carry the same host
work.  The other entry points (``csr_spmm_f32``, ``seg_reduce_f32``,
``r1l_fwd_f32``, ``r1l_bwd_f32``, ``flash_fwd_f32``, ``flash_bwd_f32``,
``r1_fwd_f32``, ``r1_bwd_f32``, ``csr_sddmm_f32``) have the same
signatures in both trees and run through this tree's wrappers with each
build's library in turn.  On the path's shapes (the GCN graph of the 2015
flow data's shape, d 32; the linkpred graph, synthetic ogbl-ddi seed 42,
d 64) the script runs ``csr_spmm_dw_f32`` in both directions (``A x``:
the CSC with the edge map; ``A^T x``: the CSR), the row softmax at rate 0
(both entries), the attention's dropout at rate 0.5 (base: the softmax,
``r1l_keep_scale_f32`` and torch's multiply forward, torch's multiply and
the softmax VJP backward; this: one softmax launch each way) and, as
controls, every ``csr_spmm_f32`` use (gc1 ``A^T x``, gc2 ``A x``, the
att-weighted ``A h`` and ``A^T g``, the ``q``-weighted dx, the d = 1
column sum), ``seg_reduce_f32`` on ``[E_pad, 64]`` values, ``r1l_fwd_f32``
at 0 and 0.5, ``r1l_bwd_f32`` at 0.5, ``flash_fwd_f32`` at 0 and 0.5,
``flash_bwd_f32`` at 0.5, ``r1_fwd_f32``, ``r1_bwd_f32`` and
``csr_sddmm_f32`` in both orientations.  It prints:

* whether each build's outputs equal the plain versions' (``out``,
  ``lse``, ``q``, ``att``, ``dw``, the softmax and the SDDMM at rtol 1e-5,
  atol 1e-6; sums, ``dx``, ``dl`` and ``dpre`` at rtol 1e-4, atol 1e-5 of
  the largest value: float32 sums of up to 3,842 terms);
* each kernel's time in four rounds in the order base, this, this, base:
  the median of 15 means of 20 launches by CUDA events, and the device
  time over 20 launches by ``torch.profiler``, with the medians of each;
* this build's ``csr_spmm_dw_f32`` in both directions at each run length
  of ``DW_RUNS`` and each group of ``DW_GROUPS`` lanes, and its
  ``seg_softmax_fwd_f32`` and ``seg_softmax_bwd_f32`` at rate 0.5 at each
  run length of ``softmax.RUN_SLOTS`` (device time);
* the materialised linkpred step (``train_step`` at ``LinkPredConfig()``,
  synthetic ogbl-ddi seed 42) with the keep mask folded (this tree's
  path) and unfolded (the base's composition: this tree's softmax at rate
  0, the base build's ``r1l_keep_scale_f32`` and torch's multiply),
  ``STEP_ROUNDS`` rounds of ``STEP_STEPS`` synchronised, unprofiled steps
  of each, the two in an order that alternates from round to round
  (base, this; this, base; ...), each round on the same batches; the
  median step of each round, the medians of those, and the rounds in
  which the folded step was the faster;
* ptxas's register, spill and stack counts of both builds.

The card's name and power limit come first, one JSON summary last.  Needs
CUDA; exits 1 without it.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

SOURCES = ("spmm", "rank1_gat", "flash_gat", "sddmm", "softmax")
# the materialised step's rounds, and synchronised steps a round
STEP_ROUNDS = 20
STEP_STEPS = 10
# the sweep of csr_spmm_dw_f32's run length and lanes an edge
DW_RUNS = (32, 64, 128)
DW_GROUPS = (8, 16)


def base_dw_warps(num_edges: int, n_rows: int, max_row: int, d: int,
                  lib) -> int:
    """Warps a block of the base build's one-block-per-row
    ``csr_spmm_dw_f32``, as its operator chose them: about one per 32
    edges of a mean row and one per 512 of the longest, 1 to 8, at most
    what its shared memory fits at width ``d``."""
    mean = num_edges / max(n_rows, 1)
    warps = int(min(8, max(1, round(mean / 32), -(-max_row // 512))))
    return min(warps, lib.csr_spmm_dw_max_warps(d))


def build_base(csrc: Path) -> dict:
    """``csrc``'s sources built as this tree builds its own (the same nvcc
    flags), into ``build/ab/``; returns the loaded libraries and logs."""
    from msha_gnn_torch.ops.cuda import _build

    out_dir = _build.BUILD_DIR.parent / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
         str(out_dir / f"lib{name}-base.so"), str(csrc / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in SOURCES}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {csrc / name}.cu:\n{log}")
        libs[name] = (ctypes.CDLL(str(out_dir / f"lib{name}-base.so")), log)
    return libs


def bind_base(base: dict, this: dict) -> None:
    """The base build's entry points: those whose signature this tree kept
    typed as this tree's wrappers type them, and the one-block-per-row
    ``csr_spmm_dw_f32``, the softmax entries without dropout and
    ``r1l_keep_scale_f32``."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, lib in base.items():
        for fn in ("csr_spmm_f32", "seg_reduce_f32", "r1l_fwd_f32",
                   "r1l_bwd_f32", "r1_fwd_f32", "r1_bwd_f32",
                   "r1l_max_warps", "r1l_error_string", "flash_fwd_f32",
                   "flash_bwd_f32", "flash_error_string",
                   "csr_spmm_error_string", "csr_sddmm_f32",
                   "csr_sddmm_error_string"):
            if hasattr(this[name], fn):
                ours = getattr(this[name], fn)
                getattr(lib, fn).argtypes = ours.argtypes
                getattr(lib, fn).restype = ours.restype
    spmm = base["spmm"]
    spmm.csr_spmm_dw_f32.argtypes = [p] * 8 + [i] * 4 + [p]
    spmm.csr_spmm_dw_max_warps.argtypes = [i]
    r1 = base["rank1_gat"]
    r1.r1l_keep_scale_f32.argtypes = [p, f, f, i, p, p]
    softmax = base["softmax"]
    softmax.seg_softmax_fwd_f32.argtypes = [p] * 6 + [i] * 4 + [p]
    softmax.seg_softmax_bwd_f32.argtypes = [p] * 5 + [i] * 4 + [p]
    for fn in (spmm.csr_spmm_dw_f32, spmm.csr_spmm_dw_max_warps,
               r1.r1l_keep_scale_f32, softmax.seg_softmax_fwd_f32,
               softmax.seg_softmax_bwd_f32):
        fn.restype = ctypes.c_int


def compare_steps(base_keep) -> dict:
    """The materialised linkpred step's unprofiled wall with the keep mask
    folded into the softmax walk (this tree's path) and unfolded (the
    base's composition: the softmax at rate 0, ``base_keep(n, seed,
    rate)`` the base build's keep-mask kernel, torch's multiply), in one
    process: the layer reaches its attention dropout through
    ``softmax.edge_softmax_drop``, which the unfolded rounds replace."""
    from msha_gnn_torch.data import load_ddi, split_edges
    from msha_gnn_torch.ops import edge_softmax
    from msha_gnn_torch.ops.cuda import softmax as sm
    from msha_gnn_torch.training import (LinkPredConfig,
                                         build_link_prediction, train_step)
    from msha_gnn_torch.training.link_prediction import epoch_batches

    def unfolded(graph, logits, seed, rate):
        return edge_softmax(graph, logits, impl="cuda") * base_keep(
            graph.num_padded_edges, seed, rate)

    split = split_edges(load_ddi(seed=42), seed=42)
    run = build_link_prediction(split, LinkPredConfig(impl="materialised"),
                                device="cuda")
    ways = {"base": unfolded, "this": sm.edge_softmax_drop}
    batches = epoch_batches(run)
    medians = {"base": [], "this": []}
    launches = {}
    try:
        for label in ("base", "this"):  # warm-up
            sm.edge_softmax_drop = ways[label]
            for batch in batches[:3]:
                train_step(run, batch)
        torch.cuda.synchronize()
        for r in range(STEP_ROUNDS):
            for label in ("base", "this")[::1 if r % 2 == 0 else -1]:
                sm.edge_softmax_drop = ways[label]
                before = (sm.fwd_launches, sm.fwd_drop_launches)
                wall = []
                for i in range(STEP_STEPS):
                    batch = batches[(3 + r * STEP_STEPS + i) % len(batches)]
                    t0 = time.perf_counter()
                    train_step(run, batch)
                    torch.cuda.synchronize()
                    wall.append((time.perf_counter() - t0) * 1e3)
                medians[label].append(statistics.median(wall))
                launches[label] = {
                    "softmax_fwd": sm.fwd_launches - before[0],
                    "softmax_fwd_dropout": sm.fwd_drop_launches - before[1]}
    finally:
        sm.edge_softmax_drop = ways["this"]
    summary = {"rounds": STEP_ROUNDS, "steps_per_round": STEP_STEPS,
               "round_medians_ms": medians,
               "this_faster_rounds": sum(
                   t < b for t, b in zip(medians["this"], medians["base"])),
               "softmax_launches_last_round": launches}
    for label, meds in medians.items():
        q = statistics.quantiles(meds, n=4)
        summary[f"{label}_ms_p50"] = statistics.median(meds)
        summary[f"{label}_ms_quartiles"] = [q[0], q[2]]
    print(f"  materialised step wall, unprofiled, {STEP_ROUNDS} rounds of "
          f"{STEP_STEPS} steps: {json.dumps(summary)}", flush=True)
    return summary


def ptxas(log: str) -> list:
    """(kernel, registers, spill bytes, stack bytes) of each entry."""
    rows, kernel, spill = [], None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].rsplit(", ", 1)[1])
        elif "registers" in line and kernel:
            regs = int(line.split("Used ")[1].split(" registers")[0])
            stack = (int(line.split("cumulative stack size")[0]
                         .rsplit(", ", 1)[1].split(" bytes")[0])
                     if "stack" in line else 0)
            rows.append((kernel, regs, spill, stack))
            spill = 0
    return rows


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def checked(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"base launch failed (error {rc})")


def sums_equal(got, want) -> bool:
    scale = float(want.abs().max()) if want.numel() else 0.0
    return bool(torch.allclose(got, want, rtol=1e-4,
                               atol=1e-5 * max(scale, 1.0)))


def lib_case(module, libs, fn):
    """``fn`` (a wrapper of ``module``) with each build's library: each
    call sets the module's library first."""
    def with_lib(lib):
        def call():
            module._lib = lib
            return fn()
        return call
    return {"base": with_lib(libs["base"]), "this": with_lib(libs["this"])}


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("usage: scripts_torch_kernel_ab.py BASE_CSRC (needs CUDA)",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from msha_gnn_torch import normalize_by_dst_degree
    from msha_gnn_torch.data import synthetic_flow
    from msha_gnn_torch.ops.cuda import _build
    from msha_gnn_torch.ops.cuda import flash_gat as flash
    from msha_gnn_torch.ops.cuda import rank1_gat as r1
    from msha_gnn_torch.ops.cuda import sddmm as sd
    from msha_gnn_torch.ops.cuda import softmax as sm
    from msha_gnn_torch.ops.cuda import spmm as cuda_spmm
    from msha_gnn_torch.ops.cuda.softmax import seg_softmax_fwd_plain

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    base = build_base(Path(sys.argv[1]))
    _build.build(SOURCES)
    this = {"spmm": cuda_spmm._kernel_lib(), "rank1_gat": r1._kernel_lib(),
            "flash_gat": flash._kernel_lib(), "sddmm": sd._kernel_lib(),
            "softmax": sm._kernel_lib()}
    base_libs = {n: lib for n, (lib, _) in base.items()}
    bind_base(base_libs, this)
    for label, logs in (("base", {n: log for n, (_, log) in base.items()}),
                        ("this", {n: _build.build_log(n) for n in SOURCES})):
        for n in SOURCES:
            for kernel, regs, spill, stack in ptxas(logs[n]):
                print(f"  ptxas {label} {n}: {kernel}: {regs} registers, "
                      f"{spill} bytes spilled, {stack} bytes stack",
                      flush=True)

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(9)
    fg = synthetic_flow(cs.N, cs.M, cs.N_CITY, cs.N_PROV, cs.RECORDS, seed=0)
    gcn = cuda_spmm.SpmmOperator(normalize_by_dst_degree(fg.inter).to(dev),
                                 dev)
    x1 = torch.rand((fg.n_src, cs.M), generator=gen, device=dev) - 0.5
    x2 = torch.rand((fg.n_dst, cs.M), generator=gen, device=dev) - 0.5
    g = cs.linkpred_split()["graph"].to(dev)
    op = r1.Rank1GatOperator(g, dst_linear=True, dropout_rate=0.5)
    spmm = op.spmm
    n, e, e_pad, d = g.n_src, g.num_edges, g.num_padded_edges, cs.LP_D
    x = torch.rand((n, d), generator=gen, device=dev) - 0.5
    gout = torch.rand((n, d), generator=gen, device=dev) - 0.5
    logits = torch.randn(e_pad, generator=gen, device=dev) * 2
    att = seg_softmax_fwd_plain(spmm.ptr, logits, None, e)[0][:e]
    q = att * r1.keep_scale_plain(torch.arange(e, device=dev), 7, 0.5)
    dcol = torch.rand((e, 1), generator=gen, device=dev) - 0.5
    values = torch.rand((e_pad, d), generator=gen, device=dev) - 0.5
    values[e:] = float("nan")
    libs = {name: {"base": base_libs[name], "this": this[name]}
            for name in SOURCES}

    # (ptr, col, w, x, n_rows) of each csr_spmm_f32 use
    spmm_uses = {
        "gc1 A^T x": (gcn.t_ptr, gcn.t_col, gcn.t_w, x1, fg.n_dst),
        "gc2 A x": (gcn.ptr, gcn.col, gcn.w, x2, fg.n_src),
        "att A h": (spmm.ptr, spmm.col, att, x, n),
        "att dx A^T g": (spmm.t_ptr, spmm.t_col, spmm.weights(att, True),
                         gout, n),
        "q dx A^T g": (spmm.t_ptr, spmm.t_col, spmm.weights(q, True), gout,
                       n),
        "dpre column sum": (spmm.t_ptr, spmm.t_edge, None, dcol, n),
    }
    cases, want = {}, {}
    for label, (ptr, col, w, xx, n_rows) in spmm_uses.items():
        k = f"csr_spmm_f32[{label}]"
        cases[k] = lib_case(cuda_spmm, libs["spmm"],
                            lambda ptr=ptr, col=col, w=w, xx=xx,
                            n_rows=n_rows: cuda_spmm.csr_spmm(ptr, col, w,
                                                              xx, n_rows))
        want[k] = (cuda_spmm.csr_spmm_plain(ptr, col, w, xx, n_rows),)
    cases["seg_reduce_f32[E_pad, 64]"] = lib_case(
        cuda_spmm, libs["spmm"], lambda: cuda_spmm.segment_reduce_sorted(
            values, g.senders, spmm.ptr, n_src=n))
    want["seg_reduce_f32[E_pad, 64]"] = (
        cuda_spmm.segment_reduce_sorted_plain(values, g.senders, spmm.ptr,
                                              n_src=n),)

    seed = torch.tensor([cs.DROP_SEED], dtype=torch.int32, device=dev)
    c = torch.randn(n, generator=gen, device=dev)
    a = torch.randn(d, generator=gen, device=dev) * 0.3
    t = torch.randn(n, generator=gen, device=dev)

    for rate in (0.0, 0.5):
        fwd_args = (op.ptr, op.col, c, a, x, seed, rate, op.slope, n)
        k = f"r1l_fwd_f32[rate {rate}]"
        cases[k] = lib_case(r1, libs["rank1_gat"],
                            lambda fwd_args=fwd_args: r1.r1l_fwd(*fwd_args))
        want[k] = r1.rank1_gat_plain(*fwd_args)
    out5, lse5 = want["r1l_fwd_f32[rate 0.5]"]
    bwd_args = (op.ptr, op.col, c, a, x, gout, out5, lse5, seed, 0.5,
                op.slope, n)
    cases["r1l_bwd_f32[rate 0.5]"] = lib_case(
        r1, libs["rank1_gat"], lambda: r1.r1l_bwd(*bwd_args))
    want["r1l_bwd_f32[rate 0.5]"] = r1.rank1_gat_bwd_plain(*bwd_args)
    for rate in (0.0, 0.5):
        f_args = (op.ptr, op.col, logits, x, seed, rate, n)
        k = f"flash_fwd_f32[rate {rate}]"
        cases[k] = lib_case(flash, libs["flash_gat"],
                            lambda f_args=f_args: flash.flash_fwd(*f_args))
        want[k] = flash.flash_gat_plain(*f_args)
    g_args = (op.ptr, op.col, c, t, x, op.slope, n)
    cases["r1_fwd_f32"] = lib_case(r1, libs["rank1_gat"],
                                   lambda: r1.r1_fwd(*g_args))
    want["r1_fwd_f32"] = r1.rank1_gat_generic_plain(*g_args)
    out_f5, lse_f5 = want["flash_fwd_f32[rate 0.5]"]
    fb_args = (op.ptr, op.col, logits, x, gout, out_f5, lse_f5, seed, 0.5, n)
    cases["flash_bwd_f32[rate 0.5]"] = lib_case(
        flash, libs["flash_gat"], lambda: flash.flash_bwd(*fb_args))
    want["flash_bwd_f32[rate 0.5]"] = flash.flash_gat_bwd_plain(*fb_args)

    out_g, lse_g = want["r1_fwd_f32"]
    gb_args = (op.ptr, op.col, c, t, x, gout, out_g, lse_g, op.slope, n)
    # r1_bwd (rank1_gat.py) launches from flash_gat's library
    cases["r1_bwd_f32"] = lib_case(flash, libs["flash_gat"],
                                   lambda: r1.r1_bwd(*gb_args))
    want["r1_bwd_f32"] = r1.rank1_gat_generic_bwd_plain(*gb_args)
    for label, (rows, cols) in (("g, x", (gout, x)), ("x, g", (x, gout))):
        k = f"csr_sddmm_f32[sddmm({label})]"
        cases[k] = lib_case(sd, libs["sddmm"],
                            lambda rows=rows, cols=cols: sd.csr_sddmm(
                                spmm.ptr, spmm.col, rows, cols, e_pad))
        want[k] = (sd.csr_sddmm_plain(spmm.ptr, spmm.col, rows, cols, e_pad),)

    # the base's keep mask: its own kernel
    def base_keep(n_slots, seed_, rate):
        out = torch.empty(n_slots, device=dev)
        checked(base_libs["rank1_gat"].r1l_keep_scale_f32(
            seed_.data_ptr(), rate, r1._scale(rate), n_slots, out.data_ptr(),
            stream()))
        return out

    # the row softmax at rate 0 through each build's own C entries (this
    # one's with no seed), into the operator's workspace, as the path
    # calls it
    sop = sm.softmax_operator_for(g)
    gsm = torch.randn(e_pad, generator=gen, device=dev)
    att_full = seg_softmax_fwd_plain(spmm.ptr, logits, None, e)[0]
    keep = r1.keep_scale_plain(torch.arange(e_pad, device=dev), seed, 0.5)

    def softmax_fwd(label, drop=False):
        def call():
            att_, lse_ = (torch.empty(k, device=dev) for k in (e_pad, n))
            if label == "base":
                checked(base_libs["softmax"].seg_softmax_fwd_f32(
                    spmm.ptr.data_ptr(), logits.data_ptr(), None,
                    att_.data_ptr(), lse_.data_ptr(), sop.ws.data_ptr(), n,
                    e, e_pad, sop.run, stream()))
                if not drop:
                    return att_, lse_
                # the base's dropout: its keep kernel, torch's multiply
                return (att_ * base_keep(e_pad, seed, 0.5),)
            att_k = torch.empty(e_pad, device=dev) if drop else None
            checked(this["softmax"].seg_softmax_fwd_f32(
                spmm.ptr.data_ptr(), logits.data_ptr(), None,
                att_.data_ptr(), None if att_k is None else att_k.data_ptr(),
                lse_.data_ptr(), sop.ws.data_ptr(),
                seed.data_ptr() if drop else None, 0.5 if drop else 0.0,
                2.0 if drop else 1.0, n, e, e_pad, sop.run, stream()))
            return (att_k,) if drop else (att_, lse_)
        return call

    def softmax_bwd(label, drop=False):
        def call():
            dl_ = torch.empty(e_pad, device=dev)
            if label == "base":
                # the base's dropout backward: torch's multiply first
                g_ = gsm * keep if drop else gsm
                checked(base_libs["softmax"].seg_softmax_bwd_f32(
                    spmm.ptr.data_ptr(), att_full.data_ptr(), g_.data_ptr(),
                    dl_.data_ptr(), sop.ws.data_ptr(), n, e, e_pad, sop.run,
                    stream()))
                return dl_
            checked(this["softmax"].seg_softmax_bwd_f32(
                spmm.ptr.data_ptr(), att_full.data_ptr(), gsm.data_ptr(),
                dl_.data_ptr(), sop.ws.data_ptr(),
                seed.data_ptr() if drop else None, 0.5 if drop else 0.0,
                2.0 if drop else 1.0, n, e, e_pad, sop.run, stream()))
            return dl_
        return call

    for drop in (False, True):
        tag = "rate 0.5" if drop else "rate 0.0"
        cases[f"seg_softmax_fwd_f32[{tag}]"] = {
            lb: softmax_fwd(lb, drop) for lb in ("base", "this")}
        cases[f"seg_softmax_bwd_f32[{tag}]"] = {
            lb: softmax_bwd(lb, drop) for lb in ("base", "this")}
    want["seg_softmax_fwd_f32[rate 0.0]"] = seg_softmax_fwd_plain(
        spmm.ptr, logits, None, e)
    want["seg_softmax_fwd_f32[rate 0.5]"] = (
        want["seg_softmax_fwd_f32[rate 0.0]"][0] * keep,)
    want["seg_softmax_bwd_f32[rate 0.0]"] = (sm.seg_softmax_bwd_plain(
        spmm.ptr, att_full, gsm, e),)
    want["seg_softmax_bwd_f32[rate 0.5]"] = (sm.seg_softmax_bwd_plain(
        spmm.ptr, att_full, gsm * keep, e),)

    # the fused SpMM backward, both directions, through each build's C
    # entry: the base's one block a row (n_warps as its operator chose
    # them), this one's edge runs into a preallocated workspace
    row_lens = {"csr": spmm.ptr.diff(), "csc": spmm.t_ptr.diff()}
    dw_ws = torch.empty(cuda_spmm.sums_ws_floats(e_pad, cuda_spmm.DW_RUN, d),
                        device=dev)
    dw_walks = {"dw of A x": (spmm.t_ptr, spmm.t_col, spmm.t_edge, "csc"),
                "dw of A^T x": (spmm.ptr, spmm.col, None, "csr")}

    def dw_case(walk, label):
        ptr, col, eid, lens = walk
        warps = base_dw_warps(e, n, int(row_lens[lens].max()), d,
                              base_libs["spmm"])

        def call():
            dx_ = torch.empty((n, d), device=dev)
            dw_ = torch.empty(e_pad, device=dev)
            eid_p = None if eid is None else eid.data_ptr()
            if label == "base":
                checked(base_libs["spmm"].csr_spmm_dw_f32(
                    ptr.data_ptr(), col.data_ptr(), eid_p, att.data_ptr(),
                    gout.data_ptr(), x.data_ptr(), dx_.data_ptr(),
                    dw_.data_ptr(), n, e_pad, d, warps, stream()))
            else:
                checked(this["spmm"].csr_spmm_dw_f32(
                    ptr.data_ptr(), col.data_ptr(), eid_p, att.data_ptr(),
                    gout.data_ptr(), x.data_ptr(), dx_.data_ptr(),
                    dw_.data_ptr(), dw_ws.data_ptr(), n, e_pad,
                    cuda_spmm.DW_RUN, r1.group_for(d), d, stream()))
            return dx_, dw_
        return call

    for k_label, walk in dw_walks.items():
        k = f"csr_spmm_dw_f32[{k_label}]"
        cases[k] = {lb: dw_case(walk, lb) for lb in ("base", "this")}
        ptr, col, eid, _ = walk
        want[k] = cuda_spmm.csr_spmm_dw_plain(ptr, col, eid, att, gout, x, n,
                                              e_pad)
    # outputs held at the kernel tolerance (the rest as sums)
    exact = {"r1l_fwd": (0, 1), "flash_fwd": (0, 1), "r1_fwd": (0, 1),
             "flash_bwd": (1,), "r1l_bwd": (0,), "r1_bwd": (0,),
             "csr_sddmm": (0,), "seg_softmax_fwd": (0, 1),
             "csr_spmm_dw": (1,)}

    def equal(k, got):
        tight = exact.get(k.split("_f32")[0], ())
        got = got if isinstance(got, tuple) else (got,)
        return all(
            bool(torch.allclose(u, v, rtol=1e-5, atol=1e-6)) if i in tight
            else sums_equal(u, v)
            for i, (u, v) in enumerate(zip(got, want[k])))

    same = {}
    for k, fns in cases.items():
        got_b, got_t = fns["base"](), fns["this"]()
        torch.cuda.synchronize()
        same[k] = {"base_equals_plain": equal(k, got_b),
                   "this_equals_plain": equal(k, got_t)}
        print(f"  {k}: base equals plain {same[k]['base_equals_plain']}, "
              f"this equals plain {same[k]['this_equals_plain']}",
              flush=True)

    times = {k: {"base": [], "this": []} for k in cases}
    dev_times = {k: {"base": [], "this": []} for k in cases}
    for label in ("base", "this", "this", "base"):
        for k, fns in cases.items():
            times[k][label].append(cs.time_ms(fns[label]))
            dev_times[k][label].append(cs.device_ms(fns[label]))
    summary = {}
    for k in cases:
        med = {lb: statistics.median(v) for lb, v in times[k].items()}
        dmed = {lb: (statistics.median(v) if None not in v else None)
                for lb, v in dev_times[k].items()}
        print(f"  {k}: events base {times[k]['base']} ms, this "
              f"{times[k]['this']} ms, medians {med['base']:.4f} / "
              f"{med['this']:.4f} ms ({med['this'] / med['base']:.3f}x); "
              f"device base {dev_times[k]['base']} ms, this "
              f"{dev_times[k]['this']} ms", flush=True)
        summary[k] = {**same[k], "base_ms": med["base"],
                      "this_ms": med["this"],
                      "base_device_ms": dmed["base"],
                      "this_device_ms": dmed["this"]}

    # this build's fused SpMM backward at each run length and group of
    # lanes, both directions, and its row softmax with dropout at each run
    # length (device time)
    cuda_spmm._lib, r1._lib, flash._lib, sd._lib, sm._lib = (
        this["spmm"], this["rank1_gat"], this["flash_gat"], this["sddmm"],
        this["softmax"])
    dw_sweep = {
        f"csr_spmm_dw_f32[{k_label}]": {
            f"run {run}, group {grp}": cs.device_ms(
                lambda ptr=ptr, col=col, eid=eid, run=run, grp=grp:
                cuda_spmm.csr_spmm_dw(ptr, col, eid, att, gout, x, n, e_pad,
                                      run=run, group=grp))
            for run in DW_RUNS for grp in DW_GROUPS}
        for k_label, (ptr, col, eid, _) in dw_walks.items()}
    softmax_walks = {
        "seg_softmax_fwd_f32[rate 0.5]": lambda run: sm.seg_softmax_fwd_drop(
            spmm.ptr, logits, None, e, seed, 0.5, run),
        "seg_softmax_bwd_f32[rate 0.5]": lambda run: sm.seg_softmax_bwd_drop(
            spmm.ptr, att_full, gsm, e, seed, 0.5, run)}
    softmax_sweep = {k: {f"run {run}": cs.device_ms(
        lambda fn=fn, run=run: fn(run)) for run in sm.RUN_SLOTS}
        for k, fn in softmax_walks.items()}
    for title, sweep in (("run lengths and groups", dw_sweep),
                         ("run lengths", softmax_sweep)):
        for k, v in sweep.items():
            print(f"  {title}, device ms, {k}: "
                  + ", ".join(f"{key} {ms:.4f}" if ms is not None
                              else f"{key} not measured"
                              for key, ms in v.items()), flush=True)

    steps = compare_steps(base_keep)
    print(json.dumps({"ab": summary, "dw_run_group_sweep_device_ms": dw_sweep,
                      "softmax_drop_run_sweep_device_ms": softmax_sweep,
                      "materialised_step_wall": steps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
