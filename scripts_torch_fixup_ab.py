"""The fix-up of the CSR sums (``msha_gnn_torch/csrc/runs.cuh``) of two
``csrc`` trees side by side on one CUDA card, and the sweep of its chunk
of runs.

    python3 scripts_torch_fixup_ab.py BASE_CSRC [--sweep] [--out PATH]

``BASE_CSRC`` is another tree's ``msha_gnn_torch/csrc`` (for example the
parent commit's, unpacked with ``git archive`` into a directory that
``.gitignore`` lists) whose ``spmm.cu`` and ``flash_gat.cu`` have this
tree's C signatures.  Both builds run through this tree's wrappers, with
each build's library set in turn, into workspaces sized for this tree
(the larger).  The cases:

* the out-of-core benchmark's heaviest slice (``gnnbench`` traffic
  ``hub50m``: 50 M edges, receiver 0 about 38%, 12 slices of
  ``ChunkedRank1Gat``): its dx pass's two transposed ``csr_spmm_f32``,
  the ``q``-weighted ``A^T g`` at d 32 and the d = 1 column sum of
  ``dpre``, held to float64 sums;
* the short rows of the linkpred graph (synthetic ogbl-ddi, seed 42, d
  64): the att-weighted ``A h``, the d = 1 column sum of ``dpre``,
  ``csr_spmm_dw_f32`` in both directions and ``r1_bwd_f32``, held to the
  plain versions.

For each case and build: whether the outputs match (the sums at rtol
1e-4, atol 1e-5 of the largest value) and two launches give the same
bits, then the device time a call by ``torch.profiler`` (kernels summed;
runs and fix-up apart) in four rounds, base, this, this, base, with the
medians.  ``--sweep`` also builds this tree's ``spmm.cu`` and
``flash_gat.cu`` at other runs a worker of the fix-up's first level
(``runs.cuh``'s ``kFixPerD1`` / ``kFixPer`` set in a copy, ``SWEEP``) and
times each case at each.  It prints ``ChunkedRank1Gat``'s ``long_crossings`` on the hub graph
and on a uniform one, the card's name and power limit first, and writes
one JSON summary to ``--out`` (default ``chiprun_out/fixup_ab.json``).
Needs CUDA; exits 1 without it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

LIBS = ("spmm", "flash_gat")
ROUNDS = ("base", "this", "this", "base")
CALLS = 20
# (runs a thread at d = 1, runs a warp above) of the first level
SWEEP = ((1, 4), (2, 8), (4, 32), (8, 16), (16, 64))
OWN_PER = (2, 8)   # this tree's (spmm.FIX_PER_D1, spmm.FIX_PER)


def with_per(csrc: Path, per) -> Path:
    """A copy of ``csrc`` in ``build/fixup_ab/`` whose ``runs.cuh`` gives a
    worker of the fix-up's first level ``per`` = (runs at d = 1, runs
    above)."""
    from msha_gnn_torch.ops.cuda import _build

    out = _build.BUILD_DIR.parent / "fixup_ab" / f"csrc-{per[0]}x{per[1]}"
    shutil.copytree(csrc, out, dirs_exist_ok=True)
    runs = (out / "runs.cuh").read_text()
    for name, value in zip(("kFixPerD1", "kFixPer"), per):
        runs, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", runs)
        assert n == 1, name
    (out / "runs.cuh").write_text(runs)
    return out


def build(csrc: Path, tag: str) -> dict:
    """``csrc``'s ``LIBS`` built with this tree's nvcc flags into
    ``build/fixup_ab/``; the libraries by name."""
    from msha_gnn_torch.ops.cuda import _build

    out_dir = _build.BUILD_DIR.parent / "fixup_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
         str(out_dir / f"lib{name}-{tag}.so"), str(csrc / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in LIBS}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {csrc / name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}-{tag}.so"))
    return libs


def bind(libs: dict, this: dict) -> None:
    """Type another build's entry points as this tree's wrappers type
    them."""
    for name, lib in libs.items():
        for fn in ("csr_spmm_f32", "seg_reduce_f32", "csr_spmm_dw_f32",
                   "csr_spmm_error_string", "r1_bwd_f32",
                   "flash_error_string"):
            if hasattr(this[name], fn) and hasattr(lib, fn):
                getattr(lib, fn).argtypes = getattr(this[name], fn).argtypes
                getattr(lib, fn).restype = getattr(this[name], fn).restype


def use(libs: dict, per=None) -> None:
    """Route this tree's wrappers to ``libs``; ``per``: the build's runs a
    worker (the workspace follows it; None: this tree's own)."""
    from msha_gnn_torch.ops.cuda import flash_gat, spmm

    spmm._lib, flash_gat._lib = libs["spmm"], libs["flash_gat"]
    spmm.FIX_PER_D1, spmm.FIX_PER = per or OWN_PER


def device_ms(fn, calls=CALLS) -> dict:
    """Device ms a call of ``fn`` by ``torch.profiler``: all its kernels,
    and those of the fix-up (``runs::fixup_kernel``) alone."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = fix = 0.0
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = (getattr(evt, "self_device_time_total", 0.0)
              or getattr(evt, "self_cuda_time_total", 0.0))
        total += us
        if "fixup_kernel" in evt.key:
            fix += us
        kernels[evt.key.replace("void ", "")[:40]] = (
            evt.count / calls, us / 1e3 / calls)
    return {"ms": total / 1e3 / calls, "fixup_ms": fix / 1e3 / calls,
            "kernels_a_call": kernels}


def sums_close(got, want) -> bool:
    want = want.to(got.device)
    scale = float(want.abs().max()) if want.numel() else 0.0
    return bool(torch.allclose(got.double(), want.double(), rtol=1e-4,
                               atol=1e-5 * max(scale, 1.0)))


def hub_cases(gen) -> tuple:
    """The heaviest slice's two dx sums, with float64 wants, and the
    counters of the hub graph and of a uniform one."""
    from gnnbench.generate import make_graph
    from msha_gnn_torch.ops.chunked_rank1 import ChunkedRank1Gat
    from msha_gnn_torch.ops.cuda import spmm

    traffic = json.loads(Path("gnnbench/traffic/hub50m.json").read_text())
    g = make_graph(traffic, 3141592653, "cuda")
    n = int(traffic["nodes"])
    op = ChunkedRank1Gat(g["senders"].cpu().numpy(),
                         g["receivers"].cpu().numpy(), n_src=n, n_dst=n,
                         num_slices=12, assume_sorted=True, device="cuda")
    counters = {"hub": {"long_crossings": op.long_crossings,
                        "longest_crossing_runs": op.longest_crossing_runs}}
    del g
    uniform = dict(traffic, edges=int(traffic["edges"]) // 12,
                   receivers={"law": "uniform"})
    gu = make_graph(uniform, 7, "cuda")
    opu = ChunkedRank1Gat(gu["senders"].cpu().numpy(),
                          gu["receivers"].cpu().numpy(), n_src=n, n_dst=n,
                          num_slices=1, assume_sorted=True, device="cuda")
    counters["uniform_one_slice"] = {
        "long_crossings": opu.long_crossings,
        "longest_crossing_runs": opu.longest_crossing_runs}
    del gu, opu
    rs = max(op.slices, key=lambda s: int((s.t_ptr[1:] - s.t_ptr[:-1]).max()))
    e, n_t = rs.t_col.numel(), rs.t_rows.numel()
    d = 32
    gout = torch.rand(n, d, generator=gen, device="cuda") - 0.5
    q = torch.rand(e, generator=gen, device="cuda")
    dpre = torch.rand(e, 1, generator=gen, device="cuda") - 0.5
    qt = q.index_select(0, rs.t_edge).contiguous()
    cases = {
        "hub q A^T g d32": (lambda: spmm.csr_spmm(rs.t_ptr, rs.t_col, qt,
                                                  gout, n_t),
                            lambda: spmm.csr_spmm_plain(
                                rs.t_ptr, rs.t_col, qt.double(),
                                gout.double(), n_t)),
        "hub dpre column sum d1": (lambda: spmm.csr_spmm(
            rs.t_ptr, rs.t_edge, None, dpre, n_t), lambda:
            spmm.csr_spmm_plain(rs.t_ptr, rs.t_edge, None, dpre.double(),
                                n_t)),
    }
    counters["slice"] = {"edges": e, "rows": n_t,
                         "longest_row": int((rs.t_ptr[1:] - rs.t_ptr[:-1])
                                            .max())}
    return cases, counters


def linkpred_cases(gen) -> dict:
    """The short-row users on the linkpred graph at d 64."""
    import chip_smoke as cs
    from msha_gnn_torch.ops.cuda import rank1_gat as r1
    from msha_gnn_torch.ops.cuda import spmm
    from msha_gnn_torch.ops.cuda.softmax import seg_softmax_fwd_plain

    g = cs.linkpred_split()["graph"].to("cuda")
    op = r1.Rank1GatOperator(g, dst_linear=True, dropout_rate=0.5)
    sp = op.spmm
    n, e, e_pad, d = g.n_src, g.num_edges, g.num_padded_edges, cs.LP_D
    x = torch.rand((n, d), generator=gen, device="cuda") - 0.5
    gout = torch.rand((n, d), generator=gen, device="cuda") - 0.5
    logits = torch.randn(e_pad, generator=gen, device="cuda") * 2
    att = seg_softmax_fwd_plain(sp.ptr, logits, None, e)[0][:e]
    dcol = torch.rand((e, 1), generator=gen, device="cuda") - 0.5
    w = torch.rand(e_pad, generator=gen, device="cuda") + 0.5
    c = torch.randn(n, generator=gen, device="cuda")
    t = torch.randn(n, generator=gen, device="cuda")
    out, lse = r1.rank1_gat_generic_plain(op.ptr, op.col, c, t, x, op.slope,
                                          n)
    cases = {
        "att A h d64": (lambda: spmm.csr_spmm(sp.ptr, sp.col, att, x, n),
                        lambda: spmm.csr_spmm_plain(sp.ptr, sp.col, att, x,
                                                    n)),
        "dpre column sum d1": (
            lambda: spmm.csr_spmm(sp.t_ptr, sp.t_edge, None, dcol, n),
            lambda: spmm.csr_spmm_plain(sp.t_ptr, sp.t_edge, None, dcol, n)),
        "csr_spmm_dw A x d64": (
            lambda: spmm.csr_spmm_dw(sp.t_ptr, sp.t_col, sp.t_edge, w, gout,
                                     x, n, e_pad)[0],
            lambda: spmm.csr_spmm_dw_plain(sp.t_ptr, sp.t_col, sp.t_edge, w,
                                           gout, x, n, e_pad)[0]),
        "csr_spmm_dw A^T x d64": (
            lambda: spmm.csr_spmm_dw(sp.ptr, sp.col, None, w, gout, x, n,
                                     e_pad)[0],
            lambda: spmm.csr_spmm_dw_plain(sp.ptr, sp.col, None, w, gout, x,
                                           n, e_pad)[0]),
        "r1_bwd_f32 dc": (
            lambda: r1.r1_bwd(op.ptr, op.col, c, t, x, gout, out, lse,
                              op.slope, n)[2],
            lambda: r1.rank1_gat_generic_bwd_plain(
                op.ptr, op.col, c, t, x, gout, out, lse, op.slope, n)[2]),
    }
    return cases


def check(label, fn, want) -> dict:
    first = fn()
    second = fn()
    torch.cuda.synchronize()
    return {"matches": sums_close(first, want),
            "same_bits": bool(torch.equal(first, second)),
            "nan": bool(first.isnan().any())}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("base_csrc", type=Path)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", type=Path,
                    default=Path("chiprun_out/fixup_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 1
    from msha_gnn_torch.ops.cuda import _build
    from msha_gnn_torch.ops.cuda import flash_gat, spmm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    assert (spmm.FIX_PER_D1, spmm.FIX_PER) == OWN_PER
    torch.backends.cuda.matmul.allow_tf32 = False
    this = {"spmm": spmm._kernel_lib(), "flash_gat": flash_gat._kernel_lib()}
    builds = {"this": (this, None), "base": (build(args.base_csrc, "base"),
                                             None)}
    if args.sweep:
        for p1, pn in SWEEP:
            if (p1, pn) == OWN_PER:
                continue
            libs = build(with_per(_build.CSRC, (p1, pn)), f"{p1}x{pn}")
            builds[f"{p1}x{pn}"] = (libs, (p1, pn))
    for label, (libs, _) in builds.items():
        if label != "this":
            bind(libs, this)
    for line in _build.build_log("spmm").splitlines():
        if "fixup_kernel" in line or "registers" in line:
            print(f"  ptxas spmm: {line.strip()}", flush=True)
    for label, (libs, per) in builds.items():
        if per:
            assert libs["spmm"].csr_fix_chunk_runs(1) == 256 * per[0]

    gen = torch.Generator(device="cuda").manual_seed(25)
    hub, counters = hub_cases(gen)
    print(f"counters: {json.dumps(counters)}", flush=True)
    cases = {**hub, **linkpred_cases(gen)}
    wants = {k: want() for k, (_, want) in cases.items()}
    summary = {"card": card, "counters": counters, "cases": {}}
    for k, (fn, _) in cases.items():
        row = {"checks": {}, "rounds": {}}
        for label, (libs, per) in builds.items():
            use(libs, per)
            row["checks"][label] = check(k, fn, wants[k])
        for label in ROUNDS + tuple(b for b in builds
                                    if b not in ("base", "this")):
            use(*builds[label])
            row["rounds"].setdefault(label, []).append(device_ms(fn))
        use(this)
        row["median_ms"] = {
            label: statistics.median(r["ms"] for r in rounds)
            for label, rounds in row["rounds"].items()}
        row["median_fixup_ms"] = {
            label: statistics.median(r["fixup_ms"] for r in rounds)
            for label, rounds in row["rounds"].items()}
        summary["cases"][k] = row
        print(f"{k}: checks {json.dumps(row['checks'])}", flush=True)
        print(f"  device ms a call {json.dumps(row['median_ms'])}; fix-up "
              f"{json.dumps(row['median_fixup_ms'])}", flush=True)
        for label in builds:
            print(f"  kernels (count, ms) a call, {label}: "
                  f"{json.dumps(row['rounds'][label][0]['kernels_a_call'])}",
                  flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(summary, indent=1))
    ok = all(c["matches"] and c["same_bits"] and not c["nan"]
             for row in summary["cases"].values()
             for c in row["checks"].values())
    print(json.dumps({"ok": ok, "median_ms": {
        k: row["median_ms"] for k, row in summary["cases"].items()}}))
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
