"""Smoke run of the PyTorch port on one NVIDIA GPU (H100), end to end.

    python3 chip_smoke.py

Phases, each reported on its own lines; any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``); TF32 off, stated.
2. build every CUDA kernel of the port from ``msha_gnn_torch/csrc``.
3. each kernel against its plain PyTorch version on the card, at the
   shapes the GCN serving path gives it, on a synthetic flow graph of the
   2015 data's shape (39,179 sources, 32 recipients, 233,887 records):
   error, median time of kernel / plain version / one PyTorch library call
   (a yardstick the port never calls), and the bytes-or-operations bound.
4. the serving path at full width (GCN, nfeat 128): checkpoint round trip,
   one full-score fill that must launch exactly the path's kernels, the
   fill against the plain path on the card and against a float64 dense
   reference on a small graph, then HTTP requests through ``make_server``.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Without CUDA it exits 1 and prints no
result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet) at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

N, M, N_CITY, N_PROV, RECORDS = 39179, 32, 291, 32, 233887
NFEAT = 128
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-6  # f32, another summation order
SLICE_TOL = 1e-5                       # log-probs, kernel vs plain path
REF_TOL = 1e-5                         # log-probs vs float64 reference
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 15, iters: int = 20) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back
    calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def spmm_bound(ptr, col, x, n_rows):
    """Least time of one CSR SpMM on this data: each input read once (only
    the rows of x that the edges reference), the output written once, and
    2 flops per edge and feature at the float32 rate."""
    e, d = col.numel(), x.shape[1]
    x_rows = int(torch.unique(col).numel())
    nbytes = 4 * ptr.numel() + 8 * e + 4 * x_rows * d + 4 * n_rows * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * e * d / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(op, fg):
    """Phase 3: csr_spmm_f32 vs its plain version at the two GCN shapes."""
    from msha_gnn_torch.ops.cuda import spmm as cuda_spmm

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    cases = [
        # (entry, TPU kernel replaced, transpose, x rows)
        ("csr_spmm_f32[gc1 A^T x]",
         "msha_gnn_tpu/ops/pallas/spmm.py:244 _visit_kernel", True, fg.n_src),
        ("csr_spmm_f32[gc2 A x]",
         "msha_gnn_tpu/ops/pallas/spmm.py:747 _hub_kernel", False, fg.n_dst),
    ]
    results = []
    for name, replaces, transpose, n_in in cases:
        x = torch.rand((n_in, M), generator=gen, device=DEVICE) - 0.5
        if transpose:
            ptr, col, w, warps = op.t_ptr, op.t_col, op.t_w, op.warps_t
            n_rows, n_cols = fg.n_dst, fg.n_src
        else:
            ptr, col, w, warps = op.ptr, op.col, op.w, op.warps
            n_rows, n_cols = fg.n_src, fg.n_dst
        got = cuda_spmm.csr_spmm(ptr, col, w, x, n_rows, warps)
        want = cuda_spmm.csr_spmm_plain(ptr, col, w, x, n_rows)
        torch.cuda.synchronize()
        abs_err = float((got - want).abs().max())
        rel_err = float(((got - want).abs() / want.abs().clamp_min(1e-12))
                        .max())
        ok = torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
        log(f"  {name}: rows {n_rows}, edges {col.numel()}, d {M}, "
            f"warps/block {warps}: max abs err {abs_err:.3e}, max rel err "
            f"{rel_err:.3e} (rtol {KERNEL_RTOL}, atol {KERNEL_ATOL})")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        a = torch.sparse_csr_tensor(ptr, col, w, size=(n_rows, n_cols),
                                    check_invariants=True)
        lib_out = torch.sparse.mm(a, x)
        if not torch.allclose(lib_out, want, rtol=1e-4, atol=1e-5):
            raise AssertionError(f"{name}: torch.sparse.mm yardstick "
                                 "disagrees with the plain version")
        ms = time_ms(lambda: cuda_spmm.csr_spmm(ptr, col, w, x, n_rows,
                                                warps))
        plain_ms = time_ms(lambda: cuda_spmm.csr_spmm_plain(ptr, col, w, x,
                                                            n_rows))
        library_ms = time_ms(lambda: torch.sparse.mm(a, x))
        bound_ms, bound_by = spmm_bound(ptr, col, x, n_rows)
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"torch.sparse.mm {library_ms:.4f} ms, bound {bound_ms:.5f} ms "
            f"({bound_by})")
        results.append({
            "name": name, "route": "cuda",
            "source": "msha_gnn_torch/csrc/spmm.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "transpose": transpose,
        })
    return results


def dense_reference(fg, model):
    """Float64 dense GCN forward from the model's weights (numpy)."""
    from msha_gnn_torch import normalize_by_dst_degree

    a = normalize_by_dst_degree(fg.inter).to_dense().double().numpy()
    sd = {k: v.detach().cpu().double().numpy()
          for k, v in model.state_dict().items()}
    h = np.maximum(a.T @ (sd["features"] @ sd["gc1.weight"])
                   + sd["gc1.bias"], 0)
    h = np.maximum(a @ (h @ sd["gc2.weight"]) + sd["gc2.bias"], 0)
    h = h - h.max(axis=1, keepdims=True)
    return h - np.log(np.exp(h).sum(axis=1, keepdims=True))


def post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def phase_slice(fg):
    """Phase 4: the GCN serving path at full width on the card."""
    from msha_gnn_torch.data import synthetic_flow
    from msha_gnn_torch.ops.cuda import spmm as cuda_spmm
    from msha_gnn_torch.ops.cuda.spmm import operator_for
    from msha_gnn_torch.server import ModelService, make_server
    from msha_gnn_torch.serving import Predictor
    from msha_gnn_torch.training import (gcn_task, restore_checkpoint,
                                         save_checkpoint)

    t0 = time.perf_counter()
    task, model = gcn_task(fg, nfeat=NFEAT, seed=0, device=DEVICE)
    log(f"  gcn_task (nfeat {NFEAT}, features "
        f"{tuple(model.features.shape)}): "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    saved = {k: v.detach().clone() for k, v in model.state_dict().items()}
    with tempfile.TemporaryDirectory() as td:
        save_checkpoint(td, model, step=1)
        with torch.no_grad():
            for p in model.parameters():
                p.zero_()
        model, _, step = restore_checkpoint(td, model)
    for k, v in model.state_dict().items():
        if not torch.equal(v, saved[k]):
            raise AssertionError(f"checkpoint round trip changed {k}")
    log(f"  checkpoint round trip (step {step}): bit-exact")

    op = operator_for(task.graph)
    predictor = Predictor.from_state(task, model)
    # the main path: counts set to 0 just before, read just after
    cuda_spmm.launches = 0
    op.launches = op.launches_transposed = 0
    t0 = time.perf_counter()
    full = predictor._full_scores()
    torch.cuda.synchronize()
    fill_ms = (time.perf_counter() - t0) * 1e3

    service = ModelService(predictor, n_src=fg.n_src,
                           class_names={i: f"P{i}" for i in range(fg.n_dst)},
                           metadata={"model": "gcn", "n_dst": fg.n_dst})
    httpd = make_server(service, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    rng = np.random.default_rng(0)
    req_ms = []
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            if json.loads(r.read()) != {"status": "ok"}:
                raise AssertionError("/healthz")
        for i in range(40):
            nodes = rng.integers(0, fg.n_src, 64).tolist()
            t0 = time.perf_counter()
            if i % 2 == 0:
                body = post(base + "/v1/predict", {"nodes": nodes, "k": 5})
                req_ms.append((time.perf_counter() - t0) * 1e3)
                for res, node in zip(body["results"], nodes):
                    ps = [e["p"] for e in res["top"]]
                    if res["node"] != node or len(ps) != 5 or \
                            ps != sorted(ps, reverse=True):
                        raise AssertionError(f"bad top-k {res}")
            else:
                body = post(base + "/v1/scores", {"nodes": nodes})
                req_ms.append((time.perf_counter() - t0) * 1e3)
                got = np.asarray(body["log_scores"])
                if got.shape != (64, fg.n_dst) or not np.allclose(
                        np.exp(got).sum(axis=1), 1.0, atol=1e-4):
                    raise AssertionError("/v1/scores rows are not "
                                         "distributions")
                want = full[torch.as_tensor(nodes, device=DEVICE)]
                if not np.array_equal(got.astype(np.float32),
                                      want.cpu().numpy()):
                    raise AssertionError("/v1/scores differs from the "
                                         "cached matrix")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    launches = {"total": cuda_spmm.launches,
                "transposed": op.launches_transposed,
                "plain": op.launches - op.launches_transposed}
    log(f"  main path launches of csr_spmm_f32: {launches}")
    if launches != {"total": 2, "transposed": 1, "plain": 1}:
        raise AssertionError(f"expected exactly 2 kernel launches per "
                             f"full-score fill, got {launches}")

    if tuple(full.shape) != (fg.n_src, fg.n_dst) or not bool(
            torch.isfinite(full).all()):
        raise AssertionError(f"full scores: shape {tuple(full.shape)} or "
                             "non-finite values")
    row_err = float((full.exp().sum(dim=1) - 1).abs().max())
    if row_err > 1e-4:
        raise AssertionError(f"rows are not distributions ({row_err:.2e})")

    task_t, model_t = gcn_task(fg, nfeat=NFEAT, seed=0, impl="torch",
                               device=DEVICE)
    model_t.load_state_dict(model.state_dict())
    before = cuda_spmm.launches
    full_t = task_t.full_scores(model_t)
    torch.cuda.synchronize()
    if cuda_spmm.launches != before:
        raise AssertionError("impl='torch' launched the CUDA kernel")
    slice_err = float((full - full_t).abs().max())
    log(f"  full scores [{fg.n_src}, {fg.n_dst}]: kernel path vs plain "
        f"path on the card: max abs err {slice_err:.3e} (atol {SLICE_TOL})")
    if slice_err > SLICE_TOL:
        raise AssertionError("kernel path disagrees with the plain path")

    small = synthetic_flow(600, 8, 20, 6, 4000, seed=1)
    task_s, model_s = gcn_task(small, nfeat=16, seed=1, device=DEVICE)
    got_s = task_s.full_scores(model_s).cpu().double().numpy()
    ref_err = float(np.abs(got_s - dense_reference(small, model_s)).max())
    log(f"  small graph (600 x 8): kernel path vs float64 dense reference: "
        f"max abs err {ref_err:.3e} (atol {REF_TOL})")
    if ref_err > REF_TOL:
        raise AssertionError("kernel path disagrees with the dense reference")

    refill_ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        task.full_scores(model)
        torch.cuda.synchronize()
        refill_ms.append((time.perf_counter() - t0) * 1e3)
    summary = {
        "first_fill_ms": fill_ms,
        "fill_ms_p50": statistics.median(refill_ms),
        "request_ms_p50": statistics.median(req_ms),
        "requests": len(req_ms), "nodes_per_request": 64,
    }
    log(f"  slice: {json.dumps(summary)}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from msha_gnn_torch import normalize_by_dst_degree
    from msha_gnn_torch.data import synthetic_flow
    from msha_gnn_torch.ops.cuda import _build
    from msha_gnn_torch.ops.cuda.spmm import SpmmOperator

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log("phase 1: card")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}; "
        "TF32 off for matmul and cudnn (full float32)")

    log("phase 2: build")
    t0 = time.perf_counter()
    built = _build.build()
    log(f"  built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    for name in built:
        for line in _build.build_log(name).splitlines():
            if "ptxas info" in line:
                log(f"  {name}: {line.strip()}")

    log(f"phase 3: kernels vs plain, synthetic flow {N} x {M}, "
        f"{RECORDS} records")
    fg = synthetic_flow(N, M, N_CITY, N_PROV, RECORDS, seed=0)
    op = SpmmOperator(normalize_by_dst_degree(fg.inter).to(DEVICE), DEVICE)
    log(f"  {fg.inter.num_edges} unique edges")
    kernels = phase_kernels(op, fg)

    log("phase 4: GCN serving path")
    launches = phase_slice(fg)
    for k in kernels:
        k["launches"] = launches["transposed" if k.pop("transpose")
                                 else "plain"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
