"""The kernels of two ``csrc`` trees side by side on one CUDA card: the same
entry points, built from each, on the same inputs.

    python3 scripts_torch_kernel_ab.py BASE_CSRC

``BASE_CSRC`` is another tree's ``msha_gnn_torch/csrc`` (for example the
parent commit's, unpacked with ``git archive`` into a directory that
``.gitignore`` lists).  Both builds of ``flash_gat.cu`` and ``spmm.cu`` run
``flash_fwd_f32`` (dropout rates 0 and 0.5), ``flash_bwd_f32`` (0.5) and
``csr_spmm_f32`` (att-weighted ``A h``, and unweighted as the dx reduce) on
the linkpred graph (synthetic ogbl-ddi, seed 42, d 64).  The script prints
whether each output is the same bit for bit, each kernel's time in four
rounds in the order base, this, this, base (each the median of 15 means of
20 launches, CUDA events) with the medians of each build, and ptxas's
register and stack counts of both builds.  The card's name and power limit
come first, one JSON summary last.  Needs CUDA; exits 1 without it.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

SOURCES = ("flash_gat", "spmm")


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


def bind(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """The argument types of the entry points both trees share."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "flash_gat":
        lib.flash_fwd_f32.argtypes = [p] * 5 + [f] * 2 + [p] * 2 + [i] * 3 + [p]
        lib.flash_bwd_f32.argtypes = [p] * 8 + [f] * 2 + [p] * 2 + [i] * 4 + [p]
        lib.flash_max_warps.argtypes = [i]
        fns = (lib.flash_fwd_f32, lib.flash_bwd_f32, lib.flash_max_warps)
        lib.flash_error_string.argtypes = [i]
        lib.flash_error_string.restype = ctypes.c_char_p
    else:
        lib.csr_spmm_f32.argtypes = [p] * 5 + [i] * 3 + [p]
        fns = (lib.csr_spmm_f32,)
        lib.csr_spmm_error_string.argtypes = [i]
        lib.csr_spmm_error_string.restype = ctypes.c_char_p
    for fn in fns:
        fn.restype = ctypes.c_int
    return lib


def ptxas(log: str) -> list:
    """(kernel, registers, stack bytes) of each entry in a build log."""
    rows, kernel = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "registers" in line and kernel:
            regs = int(line.split("Used ")[1].split(" registers")[0])
            stack = (int(line.split("cumulative stack size")[0]
                         .rsplit(", ", 1)[1].split(" bytes")[0])
                     if "stack" in line else 0)
            rows.append((kernel, regs, stack))
    return rows


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("usage: scripts_torch_kernel_ab.py BASE_CSRC (needs CUDA)",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from msha_gnn_torch.ops.cuda import _build
    from msha_gnn_torch.ops.cuda import flash_gat as fg
    from msha_gnn_torch.ops.cuda import spmm as cuda_spmm
    from msha_gnn_torch.ops.cuda.softmax import seg_softmax_fwd_plain

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    base = build_base(Path(sys.argv[1]))
    _build.build(SOURCES)
    builds = {"base": {n: bind(lib, n) for n, (lib, _) in base.items()},
              "this": {n: bind(_build.load(n), n) for n in SOURCES}}
    for label, logs in (("base", {n: log for n, (_, log) in base.items()}),
                        ("this", {n: _build.build_log(n) for n in SOURCES})):
        for n in SOURCES:
            for kernel, regs, stack in ptxas(logs[n]):
                print(f"  ptxas {label} {n}: {kernel}: {regs} registers, "
                      f"{stack} bytes stack", flush=True)

    g = cs.linkpred_split()["graph"].to("cuda")
    op = fg.FlashGatOperator(g)
    spmm = op.spmm
    n, e, e_pad, d = g.n_src, g.num_edges, g.num_padded_edges, cs.LP_D
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.rand((n, d), generator=gen, device="cuda") - 0.5
    gout = torch.rand((n, d), generator=gen, device="cuda") - 0.5
    logits = torch.randn(e_pad, generator=gen, device="cuda") * 2
    z = torch.rand((e, d), generator=gen, device="cuda") - 0.5
    seed = torch.tensor([cs.DROP_SEED], dtype=torch.int32, device="cuda")
    att = seg_softmax_fwd_plain(spmm.ptr, logits, None, e)[0][:e]
    out5, lse5 = fg.flash_gat_plain(op.ptr, op.col, logits, x, seed, 0.5, n)
    cases = {
        "flash_fwd_f32[rate 0.0]": lambda: fg.flash_fwd(
            op.ptr, op.col, logits, x, seed, 0.0, n),
        "flash_fwd_f32[rate 0.5]": lambda: fg.flash_fwd(
            op.ptr, op.col, logits, x, seed, 0.5, n),
        "flash_bwd_f32[rate 0.5]": lambda: fg.flash_bwd(
            op.ptr, op.col, logits, x, gout, out5, lse5, seed, 0.5, n),
        "csr_spmm_f32[att A h]": lambda: cuda_spmm.csr_spmm(
            spmm.ptr, spmm.col, att, x, n, spmm.warps),
        "csr_spmm_f32[dx reduce]": lambda: cuda_spmm.csr_spmm(
            spmm.t_ptr, spmm.t_edge, None, z, n, spmm.warps_t),
    }

    def use(label):
        fg._lib = builds[label]["flash_gat"]
        cuda_spmm._lib = builds[label]["spmm"]

    outputs = {}
    for label in ("base", "this"):
        use(label)
        outputs[label] = {k: fn() for k, fn in cases.items()}
    torch.cuda.synchronize()
    same = {}
    for k in cases:
        a, b = outputs["base"][k], outputs["this"][k]
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        same[k] = all(torch.equal(u, v) for u, v in zip(a, b))
        print(f"  {k}: outputs bit for bit equal: {same[k]}", flush=True)
    times = {k: {"base": [], "this": []} for k in cases}
    for label in ("base", "this", "this", "base"):
        use(label)
        for k, fn in cases.items():
            times[k][label].append(cs.time_ms(fn))
    summary = {}
    for k, t in times.items():
        med = {label: statistics.median(v) for label, v in t.items()}
        print(f"  {k}: base {t['base']} ms, this {t['this']} ms; medians "
              f"{med['base']:.4f} / {med['this']:.4f} ms "
              f"({med['this'] / med['base']:.3f}x)", flush=True)
        summary[k] = {"same_bits": same[k], **{f"{a}_ms": v
                                               for a, v in med.items()}}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
