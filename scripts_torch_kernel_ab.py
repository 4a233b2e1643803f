"""The CSR-sum and flash-GAT kernels of two ``csrc`` trees side by side on
one CUDA card: each tree's build, called through its own C signatures, on
the same inputs.

    python3 scripts_torch_kernel_ab.py BASE_CSRC

``BASE_CSRC`` is another tree's ``msha_gnn_torch/csrc`` (for example the
parent commit's, unpacked with ``git archive`` into a directory that
``.gitignore`` lists), whose ``spmm.cu`` and ``rank1_gat.cu`` have the
one-block-per-row signatures: ``csr_spmm_f32(ptr, col, w, x, out, n_rows,
d, n_warps, stream)``, ``seg_reduce_f32(ptr, values, out, n_rows, d,
n_warps, stream)`` and ``r1l_bwd_f32`` writing ``z [E, d]``.  This tree's
are the edge-run kernels.  On the path's shapes (the GCN graph of the 2015
flow data's shape, d 32; the linkpred graph, synthetic ogbl-ddi seed 42,
d 64) the script runs every ``csr_spmm_f32`` use (gc1 ``A^T x``, gc2 ``A
x``, the att-weighted ``A h`` and ``A^T g``, the ``q``-weighted flash dx,
the unweighted ``[E, 64]`` dx reduce and the d = 1 column sum),
``seg_reduce_f32`` on ``[E_pad, 64]`` values and ``r1l_bwd_f32`` at
dropout 0.5 (base: ``z``, ``dc``, ``da``; this: ``q``, ``dpre``, ``dc``,
``da``), and ``flash_fwd_f32`` (dropout rates 0 and 0.5) and
``flash_bwd_f32`` (0.5) of both builds of ``flash_gat.cu``, whose C
signatures did not change.  It prints:

* whether each build's outputs equal the plain versions' (rtol 1e-4, atol
  1e-5 of the largest value: float32 sums of up to 3,842 terms), and for
  the flash kernels whether the two builds' outputs are the same bit for
  bit;
* each kernel's time in four rounds in the order base, this, this, base:
  the median of 15 means of 20 launches by CUDA events, and the device
  time over 20 launches by ``torch.profiler``, with the medians of each;
* this build's time at each run length of ``RUN_SLOTS`` for the SpMM and
  segment-sum uses (device time);
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
from pathlib import Path

import torch

SOURCES = ("spmm", "rank1_gat", "flash_gat")


def build_base(csrc: Path) -> dict:
    """``csrc``'s sources built as this tree builds its own (the same nvcc
    flags), into ``build/ab/``; returns the loaded libraries and logs."""
    from msha_gnn_torch.ops.cuda import _build

    out_dir = _build.BUILD_DIR.parent / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name in SOURCES:
        target = out_dir / f"lib{name}-base.so"
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(target),
             str(csrc / f"{name}.cu")], capture_output=True, text=True,
            check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {csrc / name}.cu:\n"
                               f"{proc.stdout}{proc.stderr}")
        libs[name] = (ctypes.CDLL(str(target)), proc.stdout + proc.stderr)
    return libs


def bind_base(spmm_lib: ctypes.CDLL, r1_lib: ctypes.CDLL,
              flash_lib: ctypes.CDLL) -> None:
    """The one-block-per-row signatures of the base tree, and its flash
    kernels' (the same as this tree's)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    flash_lib.flash_fwd_f32.argtypes = ([p] * 5 + [f] * 2 + [p] * 2 + [i] * 3
                                        + [p])
    flash_lib.flash_bwd_f32.argtypes = ([p] * 8 + [f] * 2 + [p] * 2 + [i] * 4
                                        + [p])
    flash_lib.flash_max_warps.argtypes = [i]
    flash_lib.flash_error_string.argtypes = [i]
    flash_lib.flash_error_string.restype = ctypes.c_char_p
    spmm_lib.csr_spmm_f32.argtypes = [p] * 5 + [i] * 3 + [p]
    spmm_lib.seg_reduce_f32.argtypes = [p] * 3 + [i] * 3 + [p]
    r1_lib.r1l_bwd_f32.argtypes = [p] * 9 + [f] * 3 + [p] * 4 + [i] * 3 + [p]
    r1_lib.r1l_max_warps.argtypes = [i]
    for fn in (spmm_lib.csr_spmm_f32, spmm_lib.seg_reduce_f32,
               r1_lib.r1l_bwd_f32, r1_lib.r1l_max_warps,
               flash_lib.flash_fwd_f32, flash_lib.flash_bwd_f32,
               flash_lib.flash_max_warps):
        fn.restype = ctypes.c_int


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
    from msha_gnn_torch.ops.cuda import spmm as cuda_spmm
    from msha_gnn_torch.ops.cuda.softmax import seg_softmax_fwd_plain

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    base = build_base(Path(sys.argv[1]))
    base_spmm, base_r1 = base["spmm"][0], base["rank1_gat"][0]
    base_flash = base["flash_gat"][0]
    bind_base(base_spmm, base_r1, base_flash)
    _build.build(SOURCES)
    this_flash = flash._kernel_lib()
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
    z = torch.rand((e, d), generator=gen, device=dev) - 0.5
    dcol = torch.rand((e, 1), generator=gen, device=dev) - 0.5
    values = torch.rand((e_pad, d), generator=gen, device=dev) - 0.5
    values[e:] = float("nan")

    # (ptr, col, w, x, n_rows, base warps) of each csr_spmm_f32 use
    spmm_uses = {
        "gc1 A^T x": (gcn.t_ptr, gcn.t_col, gcn.t_w, x1, fg.n_dst,
                      gcn.warps_t),
        "gc2 A x": (gcn.ptr, gcn.col, gcn.w, x2, fg.n_src, gcn.warps),
        "att A h": (spmm.ptr, spmm.col, att, x, n, spmm.warps),
        "att dx A^T g": (spmm.t_ptr, spmm.t_col, spmm.weights(att, True),
                         gout, n, spmm.warps_t),
        "q dx A^T g": (spmm.t_ptr, spmm.t_col, spmm.weights(q, True), gout,
                       n, spmm.warps_t),
        "dx reduce [E, 64]": (spmm.t_ptr, spmm.t_edge, None, z, n,
                              spmm.warps_t),
        "dpre column sum": (spmm.t_ptr, spmm.t_edge, None, dcol, n,
                            spmm.warps_t),
    }

    def base_spmm_fn(ptr, col, w, xx, n_rows, warps):
        def fn():
            out = torch.empty((n_rows, xx.shape[1]), device=dev)
            checked(base_spmm.csr_spmm_f32(
                ptr.data_ptr(), col.data_ptr(),
                None if w is None else w.data_ptr(), xx.data_ptr(),
                out.data_ptr(), n_rows, xx.shape[1], warps, stream()))
            return out
        return fn

    def base_seg():
        out = torch.empty((n, d), device=dev)
        checked(base_spmm.seg_reduce_f32(spmm.ptr.data_ptr(),
                                         values.data_ptr(), out.data_ptr(),
                                         n, d, 8, stream()))
        return out

    seed = torch.tensor([cs.DROP_SEED], dtype=torch.int32, device=dev)
    c = torch.randn(n, generator=gen, device=dev)
    a = torch.randn(d, generator=gen, device=dev) * 0.3
    out5, lse5 = r1.rank1_gat_plain(op.ptr, op.col, c, a, x, seed, 0.5,
                                    op.slope, n)
    bwd_args = (op.ptr, op.col, c, a, x, gout, out5, lse5, seed, 0.5,
                op.slope, n)
    warps = base_r1.r1l_max_warps(d)

    def base_bwd():
        zz = torch.empty((e, d), device=dev)
        dc = torch.empty(n, device=dev)
        da = torch.empty(d, device=dev)
        part = torch.empty((n, d), device=dev)
        checked(base_r1.r1l_bwd_f32(
            op.ptr.data_ptr(), op.col.data_ptr(), c.data_ptr(), a.data_ptr(),
            x.data_ptr(), gout.data_ptr(), out5.data_ptr(), lse5.data_ptr(),
            seed.data_ptr(), 0.5, r1._scale(0.5), op.slope, zz.data_ptr(),
            dc.data_ptr(), part.data_ptr(), da.data_ptr(), n, d, warps,
            stream()))
        return zz, dc, da

    cases = {}
    plain = {}
    for label, (ptr, col, w, xx, n_rows, bw) in spmm_uses.items():
        cases[f"csr_spmm_f32[{label}]"] = {
            "base": base_spmm_fn(ptr, col, w, xx, n_rows, bw),
            "this": (lambda ptr=ptr, col=col, w=w, xx=xx, n_rows=n_rows:
                     cuda_spmm.csr_spmm(ptr, col, w, xx, n_rows))}
        plain[f"csr_spmm_f32[{label}]"] = cuda_spmm.csr_spmm_plain(
            ptr, col, w, xx, n_rows)
    cases["seg_reduce_f32[E_pad, 64]"] = {
        "base": base_seg,
        "this": lambda: cuda_spmm.segment_reduce_sorted(
            values, g.senders, spmm.ptr, n_src=n)}
    plain["seg_reduce_f32[E_pad, 64]"] = \
        cuda_spmm.segment_reduce_sorted_plain(values, g.senders, spmm.ptr,
                                              n_src=n)
    cases["r1l_bwd_f32[rate 0.5]"] = {
        "base": base_bwd, "this": lambda: r1.r1l_bwd(*bwd_args)}

    # the flash kernels: one wrapper, each build's library in turn
    def flash_case(fn):
        def with_lib(lib):
            def call():
                flash._lib = lib
                return fn()
            return call
        return {"base": with_lib(base_flash), "this": with_lib(this_flash)}

    out_f5, lse_f5 = flash.flash_gat_plain(op.ptr, op.col, logits, x, seed,
                                           0.5, n)
    for rate in (0.0, 0.5):
        cases[f"flash_fwd_f32[rate {rate}]"] = flash_case(
            lambda rate=rate: flash.flash_fwd(op.ptr, op.col, logits, x,
                                              seed, rate, n))
    cases["flash_bwd_f32[rate 0.5]"] = flash_case(
        lambda: flash.flash_bwd(op.ptr, op.col, logits, x, gout, out_f5,
                                lse_f5, seed, 0.5, n))
    wq, wdpre, wdc, wda = r1.rank1_gat_bwd_plain(*bwd_args)
    wz = (wq[:, None] * gout[cuda_spmm.edge_rows(op.ptr, e)]
          + wdpre[:, None] * a)

    same = {}
    for k, fns in cases.items():
        got_b, got_t = fns["base"](), fns["this"]()
        torch.cuda.synchronize()
        if k.startswith("flash"):
            bits = all(torch.equal(u, v) for u, v in zip(got_b, got_t))
            same[k] = {"same_bits": bits}
            print(f"  {k}: outputs bit for bit equal: {bits}", flush=True)
            continue
        if k.startswith("r1l_bwd"):
            ok_b = all(sums_equal(u, v) for u, v in zip(got_b,
                                                        (wz, wdc, wda)))
            ok_t = all(sums_equal(u, v) for u, v in zip(
                got_t, (wq, wdpre, wdc, wda)))
        else:
            ok_b, ok_t = (sums_equal(got_b, plain[k]),
                          sums_equal(got_t, plain[k]))
        same[k] = {"base_equals_plain": ok_b, "this_equals_plain": ok_t}
        print(f"  {k}: base equals plain {ok_b}, this equals plain {ok_t}",
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

    # this build at each run length
    sweep = {}
    for label, (ptr, col, w, xx, n_rows, _) in spmm_uses.items():
        sweep[f"csr_spmm_f32[{label}]"] = {
            run: cs.device_ms(lambda: cuda_spmm.csr_spmm(ptr, col, w, xx,
                                                         n_rows, run))
            for run in (*cuda_spmm.RUN_SLOTS, 512)}
    sweep["seg_reduce_f32[E_pad, 64]"] = {
        run: cs.device_ms(lambda: cuda_spmm.segment_reduce_sorted(
            values, g.senders, spmm.ptr, n_src=n, run=run))
        for run in (*cuda_spmm.RUN_SLOTS, 512)}
    sweep["r1l_bwd_f32[rate 0.5]"] = {
        run: cs.device_ms(lambda: r1.r1l_bwd(*bwd_args, run=run))
        for run in (*cuda_spmm.RUN_SLOTS, 512)}
    for k, v in sweep.items():
        print(f"  run lengths, device ms, {k}: "
              + ", ".join(f"{run} {ms:.4f}" if ms is not None
                          else f"{run} not measured"
                          for run, ms in v.items()), flush=True)
    print(json.dumps({"ab": summary, "run_sweep_device_ms": sweep}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
