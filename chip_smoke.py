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
3b. the rank-1 GAT kernels (``r1l_fwd_f32`` at dropout rate 0 and 0.5,
   ``r1l_bwd_f32``, and ``csr_spmm_f32`` as the backward's dx reduce)
   against their plain versions on the full-width link-prediction graph
   (synthetic ogbl-ddi, 4,267 nodes, 328,012 message edges, d = 64), the
   dropout keep mask bit for bit; times and bounds as in phase 3.
4. the serving path at full width (GCN, nfeat 128): checkpoint round trip,
   one full-score fill that must launch exactly the path's kernels, the
   fill against the plain path on the card and against a float64 dense
   reference on a small graph, then HTTP requests through ``make_server``.
5. the link-prediction training path at full width
   (``LinkPredConfig()``: hidden 64, 2 heads, dropout 0.5, batch 4096):
   one training step that must launch exactly its kernels, the same step
   on the plain path from the same parameters and generator state (same
   dropout masks), one epoch whose loss must fall, the device's idle share
   over a few steps, and the evaluation (Hits@20, Hits@50, AUC).

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Without CUDA it exits 1 and prints no
result.
"""

from __future__ import annotations

import copy
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

LP_SEED = 42                           # the linkpred CLI's default seed
LP_D = 64                              # LinkPredConfig().hidden
DROP_SEED = -123457                    # a fixed int32 dropout seed
# sums of up to 3,842 (dc) and 328,012 (da) terms, in another order
SUM_RTOL, SUM_ATOL_REL = 1e-4, 1e-5
STEP_LOSS_RTOL = 1e-5                  # kernel step vs plain step, loss
STEP_GRAD_RTOL, STEP_GRAD_ATOL = 1e-3, 1e-5  # and gradients: the plain
                                       # path's index_add_ adds by atomics


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


def bound(nbytes, flops):
    """Least time (ms, what bounds it) of moving ``nbytes`` at the HBM rate
    and doing ``flops`` at the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def spmm_bound(ptr, col, x, n_rows, weighted=True):
    """Least time of one CSR SpMM on this data: each input read once (only
    the rows of x that the edges reference; no weights when unweighted),
    the output written once, and 2 flops per edge and feature (1, an add,
    when unweighted)."""
    e, d = col.numel(), x.shape[1]
    x_rows = int(torch.unique(col).numel())
    per_edge = 8 if weighted else 4
    nbytes = 4 * ptr.numel() + per_edge * e + 4 * x_rows * d + 4 * n_rows * d
    return bound(nbytes, (2 if weighted else 1) * e * d)


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


def close(name, got, want, rtol, atol):
    """Max errors of ``got`` against ``want``; raises past rtol/atol."""
    abs_err = float((got - want).abs().max())
    ok = torch.allclose(got, want, rtol=rtol, atol=atol)
    log(f"  {name}: max abs err {abs_err:.3e} (max |value| "
        f"{float(want.abs().max()):.3e}; rtol {rtol}, atol {atol:.1e})")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return abs_err


def linkpred_split():
    """The linkpred CLI's data at its defaults: synthetic ogbl-ddi."""
    from msha_gnn_torch.data import load_ddi, split_edges

    return split_edges(load_ddi(seed=LP_SEED), seed=LP_SEED)


def r1l_bounds(n, e, d):
    """Least times (ms, bound) of the two rank-1 GAT kernels on this data:
    every input read once (x once: it fits in L2), every output written
    once, and the flops the function needs at the float32 rate.  ``t =
    x @ a`` depends on the column only, so it counts once per node (2 n d),
    as does ``<gout[r], out[r]>`` per row; per edge and feature the
    forward needs the aggregation's multiply-add (2 E d), the backward
    ``<gout[r], x[j]>`` (2), ``z = q gout + dpre a`` (3) and ``da``'s
    multiply-add (2)."""
    # ptr, col, c, a, x in; out, lse out
    fwd = bound(4 * (n + 1) + 4 * e + 4 * n + 4 * d + 4 * n * d
                + 4 * n * d + 4 * n, 2 * n * d + 2 * e * d)
    # ptr, col, c, a, x, gout, out, lse in; z, dc, da out
    bwd = bound(4 * (n + 1) + 4 * e + 4 * n + 4 * d + 3 * 4 * n * d
                + 4 * n + 4 * e * d + 4 * n + 4 * d, 4 * n * d + 7 * e * d)
    return fwd, bwd


def phase_rank1_kernels(split):
    """Phase 3b: r1l_fwd_f32, r1l_bwd_f32 and the dx reduce vs their
    plain versions at the linkpred shapes."""
    from msha_gnn_torch.ops.cuda import rank1_gat as r1
    from msha_gnn_torch.ops.cuda import spmm as cuda_spmm

    g = split["graph"].to(DEVICE)
    op = r1.Rank1GatOperator(g, dst_linear=True, dropout_rate=0.5)
    n, e, d = g.n_src, g.num_edges, LP_D
    deg = (op.ptr[1:] - op.ptr[:-1]).float()
    log(f"  graph: {n} rows, {e} edges ({g.num_padded_edges} padded), "
        f"row length mean {float(deg.mean()):.1f}, max {int(deg.max())}, "
        f"empty rows {int((deg == 0).sum())}; d {d}")
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    c = torch.randn(n, generator=gen, device=DEVICE)
    a = torch.randn(d, generator=gen, device=DEVICE) * 0.3
    x = torch.rand((n, d), generator=gen, device=DEVICE) - 0.5
    gout = torch.rand((n, d), generator=gen, device=DEVICE) - 0.5
    seed = torch.tensor([DROP_SEED], dtype=torch.int32, device=DEVICE)

    keep = r1.keep_scale(g.num_padded_edges, seed, 0.5)
    keep_plain = r1.keep_scale_plain(
        torch.arange(g.num_padded_edges, device=DEVICE), seed, 0.5)
    if not torch.equal(keep, keep_plain):
        raise AssertionError("the kernels' keep mask differs from "
                             "keep_scale_plain")
    log(f"  keep mask, rate 0.5, seed {DROP_SEED}: bit-exact over "
        f"{g.num_padded_edges} slots, kept share "
        f"{float((keep > 0).float().mean()):.4f}")
    log(f"  tolerances: out, lse, z at rtol {KERNEL_RTOL}, atol "
        f"{KERNEL_ATOL} (f32, another summation order); dc, da at rtol "
        f"{SUM_RTOL}, atol {SUM_ATOL_REL} x max|value| (sums of up to "
        f"{int(deg.max())} and {e} terms in another order), and so the "
        "dx reduce (sums of up to as many rows of z)")
    (fwd_b, fwd_by), (bwd_b, bwd_by) = r1l_bounds(n, e, d)
    no_lib = ("none: no single PyTorch call computes the row softmax, the "
              "hashed dropout and the aggregation together")
    results = []
    for rate in (0.0, 0.5):
        args = (op.ptr, op.col, c, a, x, seed, rate, op.slope, n)
        out, lse = r1.r1l_fwd(*args)
        want_out, want_lse = r1.rank1_gat_plain(*args)
        torch.cuda.synchronize()
        err = max(close(f"r1l_fwd_f32[rate {rate}] out", out, want_out,
                        KERNEL_RTOL, KERNEL_ATOL),
                  close(f"r1l_fwd_f32[rate {rate}] lse", lse, want_lse,
                        KERNEL_RTOL, KERNEL_ATOL))
        ms = time_ms(lambda: r1.r1l_fwd(*args))
        plain_ms = time_ms(lambda: r1.rank1_gat_plain(*args), reps=5,
                           iters=5)
        log(f"  r1l_fwd_f32[rate {rate}]: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {fwd_b:.5f} ms ({fwd_by}); library "
            f"{no_lib}")
        results.append({
            "name": f"r1l_fwd_f32[rate {rate}]", "route": "cuda",
            "source": "msha_gnn_torch/csrc/rank1_gat.cu",
            "replaces": "msha_gnn_tpu/ops/pallas/rank1_gat.py:234 "
                        "_r1l_fwd_kernel",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": fwd_b, "bound_by": fwd_by,
            "library_ms": None})
    for rate in (0.0, 0.5):
        out, lse = r1.rank1_gat_plain(op.ptr, op.col, c, a, x, seed, rate,
                                      op.slope, n)
        args = (op.ptr, op.col, c, a, x, gout, out, lse, seed, rate,
                op.slope, n)
        z, dc, da = r1.r1l_bwd(*args)
        wz, wdc, wda = r1.rank1_gat_bwd_plain(*args)
        torch.cuda.synchronize()
        err = max(
            close(f"r1l_bwd_f32[rate {rate}] z", z, wz, KERNEL_RTOL,
                  KERNEL_ATOL),
            close(f"r1l_bwd_f32[rate {rate}] dc", dc, wdc, SUM_RTOL,
                  SUM_ATOL_REL * float(wdc.abs().max())),
            close(f"r1l_bwd_f32[rate {rate}] da", da, wda, SUM_RTOL,
                  SUM_ATOL_REL * float(wda.abs().max())))
    ms = time_ms(lambda: r1.r1l_bwd(*args))
    plain_ms = time_ms(lambda: r1.rank1_gat_bwd_plain(*args), reps=5,
                       iters=5)
    log(f"  r1l_bwd_f32[rate 0.5]: kernel {ms:.4f} ms (edge grid + da "
        f"reduce), plain {plain_ms:.4f} ms, bound {bwd_b:.5f} ms "
        f"({bwd_by}); library {no_lib}")
    results.append({
        "name": "r1l_bwd_f32[rate 0.5]", "route": "cuda",
        "source": "msha_gnn_torch/csrc/rank1_gat.cu",
        "replaces": "msha_gnn_tpu/ops/pallas/rank1_gat.py:305 "
                    "_r1l_bwd_kernel",
        "launches": None, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bwd_b, "bound_by": bwd_by,
        "library_ms": None})

    spmm = op.spmm
    red_args = (spmm.t_ptr, spmm.t_edge, None, z, n, spmm.warps_t)
    got = cuda_spmm.csr_spmm(*red_args)
    want = cuda_spmm.csr_spmm_plain(*red_args[:5])
    rcv = g.receivers[:e].long()
    lib_out = z.new_zeros((n, d)).index_add_(0, rcv, z)
    torch.cuda.synchronize()
    # each output sums up to 3,842 rows of z: the sums' tolerance
    err = close("csr_spmm_f32[dx reduce] out", got, want, SUM_RTOL,
                SUM_ATOL_REL * float(want.abs().max()))
    if not torch.allclose(lib_out, want, rtol=1e-4, atol=1e-5):
        raise AssertionError("index_add_ yardstick disagrees with the "
                             "plain version")
    ms = time_ms(lambda: cuda_spmm.csr_spmm(*red_args))
    plain_ms = time_ms(lambda: cuda_spmm.csr_spmm_plain(*red_args[:5]))
    library_ms = time_ms(lambda: z.new_zeros((n, d)).index_add_(0, rcv, z))
    bound_ms, bound_by = spmm_bound(spmm.t_ptr, spmm.t_edge, z, n,
                                    weighted=False)
    log(f"  csr_spmm_f32[dx reduce]: rows {n}, edges {e}, d {d}, warps/"
        f"block {spmm.warps_t}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, index_add_ {library_ms:.4f} ms, bound {bound_ms:.5f} ms "
        f"({bound_by})")
    results.append({
        "name": "csr_spmm_f32[dx reduce]", "route": "cuda",
        "source": "msha_gnn_torch/csrc/spmm.cu",
        "replaces": "msha_gnn_tpu/ops/pallas/spmm.py:244 _visit_kernel",
        "launches": None, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms})
    return results


def read_counts(op=None):
    from msha_gnn_torch.ops.cuda import rank1_gat as r1
    from msha_gnn_torch.ops.cuda import spmm as cuda_spmm

    counts = {"r1l_fwd_f32": r1.fwd_launches,
              "r1l_bwd_f32": r1.bwd_launches,
              "csr_spmm_f32": cuda_spmm.launches}
    if op is not None:
        counts["csr_spmm_f32 transposed"] = op.launches_transposed
    return counts


def zero_counts(op=None):
    from msha_gnn_torch.ops.cuda import rank1_gat as r1
    from msha_gnn_torch.ops.cuda import spmm as cuda_spmm

    r1.fwd_launches = r1.bwd_launches = cuda_spmm.launches = 0
    if op is not None:
        op.launches = op.launches_transposed = 0


def phase_linkpred(split):
    """Phase 5: the linkpred training path at full width on the card."""
    from torch.profiler import ProfilerActivity, profile

    from msha_gnn_torch.ops.cuda.spmm import operator_for
    from msha_gnn_torch.training import (LinkPredConfig,
                                         build_link_prediction, evaluate,
                                         linkpred_loss, train_step)
    from msha_gnn_torch.training.link_prediction import epoch_batches

    t0 = time.perf_counter()
    run = build_link_prediction(split, LinkPredConfig(epochs=1),
                                device=DEVICE)
    op = operator_for(run.graph)
    if run.impl != "fused":
        raise AssertionError(f"impl auto resolved to {run.impl} on CUDA")
    batches = epoch_batches(run)
    torch.cuda.synchronize()
    log(f"  set-up {(time.perf_counter() - t0) * 1e3:.1f} ms: impl "
        f"{run.impl}, {len(batches)} steps of {batches.shape[2]} pairs, "
        f"parameters {sum(p.numel() for p in run.model.parameters())}")

    plain_model = copy.deepcopy(run.model)
    gen_state = run.generator.get_state()
    # the main path: counts set to 0 just before one step, read just after
    zero_counts(op)
    t0 = time.perf_counter()
    loss_k = train_step(run, batches[0])
    torch.cuda.synchronize()
    first_step_ms = (time.perf_counter() - t0) * 1e3
    step_counts = read_counts(op)
    log(f"  main path launches in one training step: {step_counts}")
    want = {"r1l_fwd_f32": 3, "r1l_bwd_f32": 3, "csr_spmm_f32": 3,
            "csr_spmm_f32 transposed": 3}
    if step_counts != want:
        raise AssertionError(f"expected {want} launches per step, got "
                             f"{step_counts}")

    grads_k = {k: p.grad for k, p in run.model.named_parameters()}
    gen = torch.Generator(device=DEVICE)
    gen.set_state(gen_state)
    loss_p = linkpred_loss(plain_model, run.graph, batches[0], impl="torch",
                           generator=gen)
    loss_p.backward()
    torch.cuda.synchronize()
    if read_counts(op) != step_counts:
        raise AssertionError("the plain path launched a kernel")
    loss_p = loss_p.detach()
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    log(f"  step loss: kernel path {float(loss_k):.7f}, plain path "
        f"{float(loss_p):.7f}, rel err {loss_err:.2e} (rtol "
        f"{STEP_LOSS_RTOL})")
    if loss_err > STEP_LOSS_RTOL:
        raise AssertionError("step loss: kernel path vs plain path")
    for name, p in plain_model.named_parameters():
        got, want_g = grads_k[name], p.grad
        err = float((got - want_g).abs().max())
        log(f"  grad {name} {tuple(p.shape)}: max abs err {err:.3e} (max "
            f"|value| {float(want_g.abs().max()):.3e})")
        if not torch.allclose(got, want_g, rtol=STEP_GRAD_RTOL,
                              atol=STEP_GRAD_ATOL):
            raise AssertionError(f"gradient of {name}: kernel path vs "
                                 "plain path")
    log(f"  gradients agree at rtol {STEP_GRAD_RTOL}, atol "
        f"{STEP_GRAD_ATOL}")

    losses, step_ms = [float(loss_k)], []
    t_epoch = time.perf_counter()
    for batch in batches[1:]:
        t0 = time.perf_counter()
        losses.append(float(train_step(run, batch)))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    epoch_s = time.perf_counter() - t_epoch + first_step_ms / 1e3
    first5, last5 = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    log(f"  epoch of {len(losses)} steps: loss first-5 mean {first5:.5f}, "
        f"last-5 mean {last5:.5f}")
    if not all(np.isfinite(losses)) or not last5 < first5:
        raise AssertionError("the epoch's loss did not fall")

    more = epoch_batches(run)[:5]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in more:
            train_step(run, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: a user annotation (Adam's step) spans listed kernels
    busy_us = sum(
        getattr(evt, "self_device_time_total", 0.0)
        or getattr(evt, "self_cuda_time_total", 0.0)
        for evt in prof.key_averages()
        if evt.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(evt, "is_user_annotation", False))
    idle = max(0.0, 1 - busy_us / 1e3 / wall_ms) if busy_us else None

    zero_counts(op)
    t0 = time.perf_counter()
    metrics = evaluate(run)
    eval_s = time.perf_counter() - t0
    eval_counts = read_counts(op)
    log(f"  evaluation launches: {eval_counts}")
    if eval_counts["r1l_fwd_f32"] != 3 or eval_counts["r1l_bwd_f32"] != 0:
        raise AssertionError("evaluation must run the 3 forward kernels")
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite metrics {metrics}")
    summary = {
        "step_ms_p50": statistics.median(step_ms),
        "first_step_ms": first_step_ms, "epoch_s": epoch_s,
        "device_idle_share": idle,
        "device_busy_ms_per_step": busy_us / 1e3 / len(more),
        "eval_s": eval_s, **metrics,
    }
    log(f"  linkpred: {json.dumps(summary)}")
    return step_counts, eval_counts


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

    log("phase 3b: rank-1 GAT kernels vs plain, linkpred graph "
        "(synthetic ogbl-ddi, seed 42)")
    split = linkpred_split()
    r1_kernels = phase_rank1_kernels(split)

    log("phase 4: GCN serving path")
    launches = phase_slice(fg)
    for k in kernels:
        k["launches"] = launches["transposed" if k.pop("transpose")
                                 else "plain"]

    log("phase 5: linkpred training path (LinkPredConfig defaults)")
    step, evaluation = phase_linkpred(split)
    # rate 0.5 runs in training steps, rate 0 in the evaluation's encoding
    per_name = {"r1l_fwd_f32[rate 0.0]": evaluation["r1l_fwd_f32"],
                "r1l_fwd_f32[rate 0.5]": step["r1l_fwd_f32"],
                "r1l_bwd_f32[rate 0.5]": step["r1l_bwd_f32"],
                "csr_spmm_f32[dx reduce]": step["csr_spmm_f32 transposed"]}
    for k in r1_kernels:
        k["launches"] = per_name[k["name"]]
    kernels += r1_kernels
    if any(k["launches"] < 1 for k in kernels):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{kernels}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
