"""Benchmarks (``msha_gnn_tpu/bench.py``): flagship training throughput
against a reference-style dense baseline, and SpMM / SDDMM roofline
microbenchmarks.

The reference publishes no numbers (BASELINE.md), so ``vs_baseline``
compares against *the reference's computation executed on the same card*:
a faithful dense implementation that materialises the (N, M, 2d') concat
logit tensor and the (B, N) intra attention matrices exactly as
``train.py:78-117`` does.  The port's path computes the same math in
factored / segment form.

Times on the card are CUDA events around the timed calls, read after a
synchronise; on the CPU (the tests) ``time.perf_counter``.  Every entry
point runs on ``"cuda"`` unless the caller passes ``device="cpu"``.
``run_bench``'s keys are the JAX package's, with ``xla`` read as ``torch``
and ``pallas`` as ``cuda`` (``spmm_torch``, ``sddmm_cuda``), and without
``prng`` (a JAX generator setting).  ``bench_scaling`` times the sharded
MSHA step (:mod:`msha_gnn_torch.parallel`) on the ranks of the process
group, at world size 1 without ``torchrun``.
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import resolve_device
from .data.flow import DEFAULT_DATA_DIR

# Peaks for the roofline fractions, by a lower-case substring of the
# device's name: (HBM bytes/s, float32 FLOP/s).  NVIDIA's data sheet for
# the H100 SXM at its 700 W limit; the CPU row is the JAX package's, for
# the tests.  A device not in the table gets the CPU row, as in JAX.
DEVICE_PEAKS = {
    "h100 80gb hbm3": (3.35e12, 67e12),
    "cpu": (50e9, 1e12),
}
# The MFU denominator: the dense bf16 tensor-core peak, the conservative
# convention of the JAX package (float32 GEMMs measured against the
# fastest rate the card has).  No row: no MFU (the CPU).
DEVICE_PEAK_FLOPS = {
    "h100 80gb hbm3": 989.4e12,
}
# Optimiser steps a timed call: the flagship's and the size sweep's
# multi-step calls (as Trainer.fit runs them), the dense baseline's loop
# (the JAX package's scan lengths)
FLAGSHIP_SCAN_STEPS, SWEEP_SCAN_STEPS, DENSE_SCAN_STEPS = 64, 32, 8
VALID_WHICH = ("all", "flagship", "spmm", "sddmm", "size_sweep", "scaling")


def device_name(device="cuda") -> str:
    """The card's name (``torch.cuda.get_device_name``), or ``"cpu"``."""
    dev = resolve_device(device)
    return "cpu" if dev.type == "cpu" else torch.cuda.get_device_name(dev)


def _lookup(table: dict, device):
    kind = device_name(device).lower()
    for key, value in table.items():
        if key in kind:
            return value
    return None


def device_peaks(device="cuda"):
    """(HBM bytes/s, float32 FLOP/s) of ``device`` (:data:`DEVICE_PEAKS`)."""
    return _lookup(DEVICE_PEAKS, device) or DEVICE_PEAKS["cpu"]


def device_peak_flops(device="cuda") -> Optional[float]:
    """Peak matmul FLOP/s of ``device`` for the MFU denominator
    (:data:`DEVICE_PEAK_FLOPS`), None where the table has no row."""
    return _lookup(DEVICE_PEAK_FLOPS, device)


def _seconds(run, dev: torch.device) -> float:
    """Seconds that ``run()`` takes: between two CUDA events on the card,
    read after a synchronise; ``time.perf_counter`` on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        run()
        return time.perf_counter() - t0
    with torch.cuda.device(dev):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timeit(fn, *args, warmup=3, iters=20, device=None):
    """Mean seconds of one call: ``warmup`` calls, then ``iters`` calls
    between two CUDA events, then a synchronise.  ``device`` defaults to
    the first argument's."""
    dev = args[0].device if device is None else resolve_device(device)
    for _ in range(warmup):
        fn(*args)
    _sync(dev)

    def run():
        for _ in range(iters):
            fn(*args)

    return _seconds(run, dev) / iters


def _first_leaf(out) -> torch.Tensor:
    while isinstance(out, (tuple, list)):
        out = out[0]
    return out


def _timeit_chain(fn, *args, iters=10):
    """Dependency-chained timing: ``iters`` calls in a Python loop, each
    on ``args[0] + c * 1e-12``, where the carry ``c`` is the previous
    output's first leaf's first plus last element plus ``0.5 * c``, so no
    call can overlap or be skipped; one CUDA-event pair around the loop,
    after one untimed warm run.  JAX's runs the loop in one ``lax.scan``
    dispatch.  Biases (both small and the same for every row): one
    elementwise pass over ``args[0]`` and a few one-element kernels a
    call, and one synchronise a run."""
    x0, rest = args[0], args[1:]
    dev = x0.device

    def run():
        c = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(iters):
            leaf = _first_leaf(fn(x0 + c * 1e-12, *rest)).reshape(-1)
            c = (leaf[0] + leaf[-1]).float() + c * 0.5
        return c

    float(run())  # warm
    return _seconds(run, dev) / iters


# ---------------------------------------------------------------------------
# Reference-style dense MSHA (baseline): materialises what the reference
# materialises (train.py:78-117); used only as the timing baseline.
# ---------------------------------------------------------------------------

def dense_reference_msha_forward(params, s_feat, r_feat, inter_adj,
                                 city_rows, prov_rows, batch, generator,
                                 dropout=0.5):
    """``city_rows``/``prov_rows``: the (B, N) rows ``city_adj[batch]``,
    the only slices of the N x N cliques the reference's forward ever
    reads (train.py:95-96), so the baseline is given them precomputed
    rather than the full N x N buffers.  Training-mode dropout is applied
    at every site the reference applies it (features, each attention
    matrix, the head concat, the output layer's attention), in that order,
    its masks drawn from ``generator``, so baseline and framework steps do
    the same work.  ``params``: per-head dicts ``attention_<i>`` (``W1``,
    ``W2``, ``a``, ``a3``, ``a4``) and ``out_att`` (``W``, ``a``), as
    :func:`dense_reference_params` gives them."""
    from .ops.dense import dropout as _dropout

    def leaky(x):
        return F.leaky_relu(x, 0.2)

    def drop(x):
        return _dropout(x, dropout, generator=generator, deterministic=False)

    outs = []
    n, m = inter_adj.shape
    heads = sorted(k for k in params if k.startswith("attention_"))
    s_feat = drop(s_feat)
    r_feat = drop(r_feat)
    for head in heads:
        p = params[head]
        h1 = r_feat @ p["W1"]
        h2 = s_feat @ p["W2"]
        d = h1.shape[1]
        # (N, M, 2d') concat tensor, exactly as train.py:78
        inter_input = torch.cat([h1[None, :, :].expand(n, m, d),
                                 h2[:, None, :].expand(n, m, d)], dim=2)
        e12 = leaky((inter_input @ p["a"])[:, :, 0])
        att_inter = torch.softmax(torch.where(inter_adj > 0, e12, -9e15),
                                  dim=1)
        att_inter = drop(att_inter)

        h2_b = h2[batch]
        b = h2_b.shape[0]
        # (B, N, 2d') self-concat tensors (train.py:85-92)
        rep = h2_b[:, None, :].expand(b, n, d)
        e3 = leaky((torch.cat([rep, rep], 2) @ p["a3"])[:, :, 0])
        e4 = leaky((torch.cat([rep, rep], 2) @ p["a4"])[:, :, 0])
        att3 = torch.where(city_rows > 0, e3, -9e15)
        att4 = torch.where(prov_rows > 0, e4, -9e15)
        denom = (torch.exp(att3).sum(1, keepdim=True)
                 + torch.exp(att4).sum(1, keepdim=True)
                 + torch.exp(att_inter[batch]).sum(1, keepdim=True))
        att3 = drop(torch.exp(att3) / denom)
        att4 = drop(torch.exp(att4) / denom)

        inter_rc = att_inter @ h1
        intra_nc = att3.T @ h2_b + att4.T @ h2_b
        norm = (1 + 1e-5) ** 0.5
        v = leaky((att_inter.T @ h2) / norm)
        u = leaky((inter_rc + intra_nc) / norm)
        outs.append(F.elu(u @ v.T))
    x = drop(torch.cat(outs, dim=1))
    po = params["out_att"]
    h = x @ po["W"]
    row = leaky(torch.cat([h, h], 1) @ po["a"][:, 0])
    att = torch.softmax(
        torch.where(inter_adj > 0, row[:, None].expand(h.shape), -9e15),
        dim=1)
    att = drop(att)
    x = F.elu(att * h)
    return F.log_softmax(x, dim=1)


def dense_reference_params(model) -> dict:
    """The per-head parameters of the dense baseline, copied out of an
    ``MSHA`` model as ``bench.py:253-262`` unpacks the JAX state: the
    head-stacked ``attention`` layer's ``W1``, ``W2``, ``a`` (and ``a3``,
    ``a4`` with the intra channels) as ``attention_<i>``, and every
    parameter of ``out_att``; leaves that require a gradient."""
    att = model.attention
    names = [k for k in ("W1", "W2", "a", "a3", "a4") if hasattr(att, k)]

    def leaf(t):
        return t.detach().clone().requires_grad_()

    params = {f"attention_{i}": {k: leaf(getattr(att, k)[i]) for k in names}
              for i in range(att.W1.shape[0])}
    params["out_att"] = {k: leaf(v)
                         for k, v in model.out_att.named_parameters()}
    return params


def bench_flagship(
    batch_size: int = 64,
    in_features: int = 128,
    out_features: int = 64,
    iters: int = 20,
    baseline_n: Optional[int] = None,
    year: str = "2015",
    data_dir: str = DEFAULT_DATA_DIR,
    device="cuda",
):
    """Train-step throughput of the flagship MSHA vs the dense baseline.

    Returns a dict with records/s for both paths and the speedup.  Reads
    ``year`` of the dataset in ``data_dir``; ``baseline_n`` cuts the dense
    baseline to its first rows (it needs O(N*M*d' + B*N*d') memory, and
    autograd keeps its concat tensors: a few GB at the 2015 size), its
    step time scaled back to the full N (its dominant terms are linear in
    N).  The JAX signature's ``n``, which it does not use, is left out.

    ``flops_per_step``: ``torch.utils.flop_counter.FlopCounterMode`` over
    one untimed multi-step call, over its steps; it counts the matrix
    products (GEMMs) only, where XLA's ``cost_analysis`` counts every
    operation.  ``mfu`` divides it by the step time and
    :func:`device_peak_flops`; None where that is None.
    """
    from torch.utils.flop_counter import FlopCounterMode

    from .data import load_flow_graph
    from .training import TrainState, msha_task
    from .training.trainer import make_train_multi_step, make_train_step

    dev = resolve_device(device)
    fg = load_flow_graph(year, data_dir)
    rng = np.random.default_rng(0)
    src = fg.edge_src.numpy()
    dst = fg.edge_dst.numpy()

    task, model = msha_task(fg, in_features=in_features,
                            out_features=out_features, use_intra=True,
                            joint_softmax=True, device=dev)
    state = TrainState.create(model, task.optimizer)
    step = make_train_step(task)

    def on(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    ids = rng.integers(0, len(src), batch_size)
    batch = on(src[ids], torch.int32)
    labels = on(dst[ids], torch.int32)
    w = torch.ones(batch_size, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def run_chain(k):
        for _ in range(k):
            step(state, batch, labels, w, gen)

    run_chain(3)  # warm-up
    _sync(dev)
    t_single = _seconds(lambda: run_chain(iters), dev) / iters

    # S optimiser steps a call, as Trainer.fit runs them (the loss read
    # once a call)
    mstep = make_train_multi_step(task)
    s_steps = FLAGSHIP_SCAN_STEPS
    ids_s = rng.integers(0, len(src), (s_steps, batch_size))
    bs = on(src[ids_s], torch.int32)
    ls = on(dst[ids_s], torch.int32)
    ws = torch.ones((s_steps, batch_size), dtype=torch.float32, device=dev)
    mstep(state, bs, ls, ws, gen)
    _sync(dev)
    reps = max(iters // 8, 2)

    def run_multi():
        for _ in range(reps):
            mstep(state, bs, ls, ws, gen)

    t_ours = _seconds(run_multi, dev) / (reps * s_steps)

    # ---- dense reference-style baseline (forward + backward + adam) ----
    b_n = baseline_n or fg.n_src
    inter_adj = fg.inter.to(dev).to_dense()[:b_n]
    gid_c = fg.city.group_id.numpy()[:b_n]
    gid_p = fg.province.group_id.numpy()[:b_n]
    s_feat = on(rng.standard_normal((b_n, in_features)), torch.float32)
    r_feat = on(rng.standard_normal((fg.n_dst, in_features)), torch.float32)
    params = dense_reference_params(state.model)
    b_batch_np = rng.integers(0, b_n, batch_size)
    b_batch = on(b_batch_np, torch.long)
    city_rows = on(gid_c[b_batch_np][:, None] == gid_c[None, :],
                   torch.float32)
    prov_rows = on(gid_p[b_batch_np][:, None] == gid_p[None, :],
                   torch.float32)
    b_labels = labels.long()
    opt = torch.optim.Adam([t for p in params.values() for t in p.values()],
                           lr=1e-3)
    # the JAX baseline draws every step's masks from one fixed key
    bench_gen = torch.Generator(device=dev)

    def dense_steps():
        for _ in range(DENSE_SCAN_STEPS):
            bench_gen.manual_seed(7)
            opt.zero_grad(set_to_none=True)
            logp = dense_reference_msha_forward(
                params, s_feat, r_feat, inter_adj, city_rows, prov_rows,
                b_batch, bench_gen)
            loss = -logp[b_batch].gather(1, b_labels[:, None]).mean()
            loss.backward()
            opt.step()
        return loss.detach()

    t_dense = _timeit(dense_steps, warmup=1, iters=max(iters // 8, 2),
                      device=dev) / DENSE_SCAN_STEPS
    # normalise the baseline's time to full N (its cost is about linear in
    # N for the dominant (N, M, 2d') and (B, N) terms)
    t_dense_full = t_dense * (fg.n_src / b_n)

    # MFU of the flagship step: its GEMM FLOPs over the measured step time
    # and the card's peak
    with FlopCounterMode(display=False) as counter:
        mstep(state, bs, ls, ws, gen)
    flops_per_step = float(counter.get_total_flops()) / s_steps
    peak = device_peak_flops(dev)
    mfu = flops_per_step / t_ours / peak if peak else None

    return {
        "n": fg.n_src,
        "m": fg.n_dst,
        "batch_size": batch_size,
        "step_seconds": t_ours,
        "single_dispatch_step_seconds": t_single,
        "records_per_s": batch_size / t_ours,
        "flops_per_step": flops_per_step,
        "mfu": mfu,
        "dense_baseline_step_seconds": t_dense_full,
        "dense_baseline_n": b_n,
        "speedup_vs_dense_reference": t_dense_full / t_ours,
    }


# ---------------------------------------------------------------------------
# Kernel microbenchmarks
# ---------------------------------------------------------------------------

def make_powerlaw_graph(n_src, n_dst, n_edges, d=128, seed=0, alpha=1.5,
                        device="cuda"):
    """A graph whose destinations are drawn with zipf-like popularity
    (degree skew), unit weights, duplicate pairs kept, and ``x`` [n_dst,
    d] standard normal; both on ``device``.  The JAX package's draws."""
    from .graph import BipartiteGraph

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_dst + 1) ** alpha
    p /= p.sum()
    src = rng.integers(0, n_src, n_edges)
    dst = rng.choice(n_dst, n_edges, p=p)
    g = BipartiteGraph.from_coo(
        src, dst, np.ones(n_edges, np.float32), n_src=n_src, n_dst=n_dst,
        combine_duplicates=False,
    )
    x = torch.as_tensor(rng.standard_normal((n_dst, d)), dtype=torch.float32)
    return g.to(dev), x.to(dev)


def bench_spmm(n_src=131072, n_dst=131072, n_edges=2_000_000, d=128,
               impl="cuda", iters=20, device="cuda"):
    """SpMM ``A @ x`` edges/s and HBM roofline fractions.

    ``impl="cuda"``: the kernel ``csr_spmm_f32`` through
    :class:`~msha_gnn_torch.ops.cuda.spmm.SpmmOperator`; ``"torch"``: the
    plain path, ``ops.spmm(impl="torch")`` (a gather, a multiply and an
    ``index_add_``).  ``strict_roofline_fraction`` counts one row read an
    edge, its index and weight, and one output write.
    ``roofline_fraction`` adds the ``(E, d)`` intermediate that a TPU's
    gather-then-reduce writes and reads again; the port's kernel never
    writes it, so that fraction overstates it.  With the hub columns of
    the power-law graph read again from L2 (``x`` is 64 MiB at the
    defaults, the H100's L2 50 MiB), either fraction may read above 1: it
    is reported, not clamped.
    """
    from .ops import spmm

    g, x = make_powerlaw_graph(n_src, n_dst, n_edges, d, device=device)
    if impl == "cuda":
        from .ops.cuda.spmm import SpmmOperator

        op = SpmmOperator.build(g)

        def f(x):
            return op(x)
    elif impl == "torch":
        def f(x):
            return spmm(g, x, impl="torch")
    else:
        raise ValueError(f"unknown impl {impl!r} (cuda | torch)")
    t = _timeit(f, x, iters=iters)
    e_pad = g.num_padded_edges
    bw, _ = device_peaks(x.device)
    # strict streaming roofline: one random row read an edge, its index
    # and weight, one output write; the algorithm's lower bound
    strict_bytes = e_pad * (4 + 4 + 4 * d) + n_src * d * 4
    # with the (E, d) intermediate of a gather-then-reduce, written and
    # read again
    phase_bytes = strict_bytes + 2 * e_pad * d * 4
    return {
        "impl": impl,
        "edges": n_edges,
        "d": d,
        "seconds": t,
        "edges_per_s": n_edges / t,
        "effective_gbps": phase_bytes / t / 1e9,
        "roofline_fraction": (phase_bytes / bw) / t,
        "strict_roofline_fraction": (strict_bytes / bw) / t,
    }


def bench_sddmm(n_src=131072, n_dst=131072, n_edges=2_000_000, d=128,
                impl="torch", iters=20, device="cuda"):
    """Vector SDDMM, the per-edge ``<h_s, h_r>`` over d dims, edges/s and
    the HBM roofline fraction (one destination row read an edge, the
    streamed source rows, the index pair and the logit written; the hub
    rows read again from L2 may put it above 1, reported, not clamped).
    ``impl="cuda"``: the kernel ``csr_sddmm_f32`` through
    :class:`~msha_gnn_torch.ops.cuda.sddmm.SddmmOperator`; ``"torch"``:
    ``ops.sddmm_dot(impl="torch")``, two row gathers and a row sum.  The
    models' hot paths use rank-1 factored logits that avoid per-edge
    vector SDDMM entirely."""
    from .ops import sddmm_dot

    g, _ = make_powerlaw_graph(n_src, n_dst, n_edges, d=1, device=device)
    dev = g.device
    rng = np.random.default_rng(1)
    a = torch.as_tensor(rng.standard_normal((n_src, d)), dtype=torch.float32,
                        device=dev)
    b = torch.as_tensor(rng.standard_normal((n_dst, d)), dtype=torch.float32,
                        device=dev)
    if impl == "cuda":
        from .ops.cuda.sddmm import SddmmOperator
        from .ops.cuda.spmm import SpmmOperator

        op = SddmmOperator.build(g, spmm=SpmmOperator.build(g))

        def f(a, b):
            return op(a, b)
    elif impl == "torch":
        def f(a, b):
            return sddmm_dot(g, a, b)
    else:
        raise ValueError(f"unknown impl {impl!r} (cuda | torch)")
    t = _timeit(f, a, b, iters=iters)
    e_pad = g.num_padded_edges
    # one random dst-row read an edge + streamed src rows + logit write
    bytes_moved = e_pad * (4 * d + 8 + 4) + n_src * d * 4
    bw, _ = device_peaks(dev)
    return {
        "impl": impl,
        "edges": n_edges,
        "d": d,
        "seconds": t,
        "edges_per_s": n_edges / t,
        "roofline_fraction": (bytes_moved / bw) / t,
    }


# ---------------------------------------------------------------------------
# The inter attention at flagship scale: dense against the kernels
# ---------------------------------------------------------------------------

def attention_inputs(graph, d: int = 64) -> dict:
    """The attention benchmark's inputs on ``graph``'s device, the JAX
    package's draws (seed 0): ``h1`` [M, d], ``h2`` [N, d], ``a_src``,
    ``a_dst`` [d], the dense edge ``mask`` [N, M], and the cotangents
    ``ct_n`` [N, d], ``ct_m`` [M, d] of the two outputs."""
    n, m, dev = graph.n_src, graph.n_dst, graph.device
    rng = np.random.default_rng(0)

    def draw(shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32, device=dev)

    h1, h2, a_src, a_dst = draw((m, d)), draw((n, d)), draw(d), draw(d)
    mask = graph.to_dense() > 0
    return {"h1": h1, "h2": h2, "a_src": a_src, "a_dst": a_dst,
            "mask": mask, "ct_n": draw((n, d)), "ct_m": draw((m, d))}


def attention_dense_path(h1, h2, a_src, a_dst, mask):
    """The MSHA inter channel's dense form: rank-1 logits over the full
    (N, M), the edges' mask at -9e15, the row softmax, then ``att @ h1``
    [N, d] and ``att.T @ h2`` [M, d].  A row without edges comes out
    uniform here and zero on the sparse path."""
    s_src = h2 @ a_src
    s_dst = h1 @ a_dst
    e12 = F.leaky_relu(s_src[:, None] + s_dst[None, :], 0.2)
    att = torch.softmax(torch.where(mask, e12, -9e15), dim=1)
    return att @ h1, att.T @ h2


def attention_operators(graph, host=None):
    """``(spmm, sddmm, softmax)`` operators of ``graph`` for
    :func:`attention_sparse_path`, their arrays read from ``host`` (the
    same graph on the CPU) when given."""
    from .ops.cuda.sddmm import SddmmOperator
    from .ops.cuda.softmax import SegmentSoftmaxOperator
    from .ops.cuda.spmm import SpmmOperator

    op = SpmmOperator(graph, graph.device, host=host)
    return (op, SddmmOperator(graph, spmm=op),
            SegmentSoftmaxOperator.build(graph, host=host))


def attention_sparse_path(h1, h2, a_src, a_dst, ops):
    """The same function on the edge list through the kernels: the rank-1
    logits by ``csr_sddmm_f32`` on the width-2 columns ``[s_src, 1]``,
    ``[1, s_dst]``, leaky ReLU, the row softmax (``seg_softmax_fwd_f32``,
    as ``edge_softmax_cuda``), then ``csr_spmm_f32`` with the attention as
    the edge weight, plain and transposed.  Under autograd the backward
    launches ``seg_softmax_bwd_f32``, ``csr_sddmm_f32`` for each SpMM's
    ``dw``, ``csr_spmm_f32`` for each ``dx`` and the logits' two d = 2
    adjoints."""
    op, dop, sop = ops
    s_src = h2 @ a_src
    s_dst = h1 @ a_dst
    logits = F.leaky_relu(
        dop(torch.stack([s_src, torch.ones_like(s_src)], dim=1),
            torch.stack([torch.ones_like(s_dst), s_dst], dim=1)), 0.2)
    att = sop(logits)
    return (op(h1, edge_weight=att),
            op(h2, edge_weight=att, transpose=True))


def attention_grads(path, h1, h2, ct_n, ct_m):
    """``(dh1, dh2)`` of ``<u, ct_n> + <v, ct_m>`` for ``(u, v) =
    path(h1, h2)``."""
    h1 = h1.detach().requires_grad_()
    h2 = h2.detach().requires_grad_()
    u, v = path(h1, h2)
    s = (u * ct_n).sum() + (v * ct_m).sum()
    return torch.autograd.grad(s, (h1, h2))


def bench_flagship_attention_paths(year: str = "2015", d: int = 64,
                                   data_dir: str = DEFAULT_DATA_DIR,
                                   device="cuda"):
    """Dense vs the kernels' inter attention at FLAGSHIP scale: the MSHA
    inter channel keeps a dense (N, M=32) attention matrix
    (``models/msha.py``'s design note); this measures the alternative,
    the same computation (rank-1 logits -> row softmax -> ``att @ h1`` and
    ``att.T @ h2``) on the inter CSR edge list of ``year`` through the
    kernels (:func:`attention_sparse_path` against
    :func:`attention_dense_path`), forward and forward plus gradients,
    timed chained (:func:`_timeit_chain`).  ``dense_over_sparse_*`` is the
    sparse time over the dense one, the JAX package's ratio."""
    from .data import load_flow_graph

    dev = resolve_device(device)
    fg = load_flow_graph(year, data_dir)
    g = fg.inter.to(dev)
    n, m, e = g.n_src, g.n_dst, g.num_edges
    x = attention_inputs(g, d)
    ops = attention_operators(g, host=fg.inter)
    dense = functools.partial(attention_dense_path, a_src=x["a_src"],
                              a_dst=x["a_dst"], mask=x["mask"])
    sparse = functools.partial(attention_sparse_path, a_src=x["a_src"],
                               a_dst=x["a_dst"], ops=ops)

    def gr(path):
        return functools.partial(attention_grads, path, ct_n=x["ct_n"],
                                 ct_m=x["ct_m"])

    out = {"n": n, "m": m, "edges": e, "e_pad": g.num_padded_edges, "d": d}
    out["dense_fwd"] = _timeit_chain(dense, x["h1"], x["h2"])
    out["sparse_fwd"] = _timeit_chain(sparse, x["h1"], x["h2"])
    out["dense_fwd_grad"] = _timeit_chain(gr(dense), x["h1"], x["h2"])
    out["sparse_fwd_grad"] = _timeit_chain(gr(sparse), x["h1"], x["h2"])
    out["dense_over_sparse_fwd"] = out["sparse_fwd"] / out["dense_fwd"]
    out["dense_over_sparse_fwd_grad"] = (
        out["sparse_fwd_grad"] / out["dense_fwd_grad"])
    return out


def bench_flagship_size_sweep(
    sizes=(39179, 156716, 626864),
    batch_size: int = 64,
    in_features: int = 128,
    out_features: int = 64,
    records_per_node: int = 6,
    iters: int = 16,
    device="cuda",
):
    """MSHA train-step time vs source-node count N, on synthetic flow
    graphs with the real data's shape (M = 32, 291 cities, 25 provinces;
    :func:`~msha_gnn_torch.data.synthetic_flow`, the JAX package's
    draws).  The reference's dense formulation is capped by device
    memory: its (N, M, 2d') logit tensor alone grows linearly with N,
    before autodiff residuals; the factored path's step scales about
    linearly in N, and this sweep gives the constant
    (``ns_per_node_per_step``)."""
    from .data import synthetic_flow
    from .training import TrainState, msha_task
    from .training.trainer import make_train_multi_step

    dev = resolve_device(device)
    out = {}
    for n in sizes:
        fg = synthetic_flow(n, 32, 291, 25, records_per_node * n)
        task, model = msha_task(fg, in_features=in_features,
                                out_features=out_features, use_intra=True,
                                joint_softmax=True, device=dev)
        state = TrainState.create(model, task.optimizer)
        mstep = make_train_multi_step(task)
        rng = np.random.default_rng(0)
        src = fg.edge_src.numpy()
        dst = fg.edge_dst.numpy()
        s_steps = SWEEP_SCAN_STEPS
        ids = rng.integers(0, len(src), (s_steps, batch_size))
        bs = torch.as_tensor(src[ids], dtype=torch.int32, device=dev)
        ls = torch.as_tensor(dst[ids], dtype=torch.int32, device=dev)
        ws = torch.ones((s_steps, batch_size), dtype=torch.float32,
                        device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        mstep(state, bs, ls, ws, gen)
        _sync(dev)
        reps = max(iters // 8, 2)

        def run():
            for _ in range(reps):
                mstep(state, bs, ls, ws, gen)

        t = _seconds(run, dev) / (reps * s_steps)
        out[str(n)] = {
            "step_seconds": t,
            "records_per_s": batch_size / t,
            "ns_per_node_per_step": t / n * 1e9,
        }
    return out


def bench_serving(
    batch_size: int = 1024,
    top_k: int = 3,
    iters: int = 30,
    year: str = "2015",
    data_dir: str = DEFAULT_DATA_DIR,
    device="cuda",
):
    """Predictions/s of the serving Predictor on the flow graph of
    ``year``, both paths: the full-scores cache (batch-independent models:
    MSHA without the intra channels) and the per-batch recompute (full
    MSHA).  A call of ``top_k`` reads its result to the host."""
    from .data import load_flow_graph
    from .serving import Predictor
    from .training import msha_task

    dev = resolve_device(device)
    fg = load_flow_graph(year, data_dir)
    rng = np.random.default_rng(0)
    nodes = rng.integers(0, fg.n_src, batch_size).astype(np.int32)
    out = {}
    for name, kw in (("full_scores_cache", dict(use_intra=False)),
                     ("per_batch", dict(use_intra=True))):
        task, model = msha_task(fg, in_features=128, out_features=64,
                                device=dev, **kw)
        pred = Predictor.from_state(task, model, batch_size=batch_size)
        pred.top_k(nodes, top_k)  # warm, and the cache filled

        def run():
            for _ in range(iters):
                pred.top_k(nodes, top_k)

        dt = _seconds(run, dev) / iters
        out[name] = {
            "batch_seconds": dt,
            "predictions_per_s": batch_size / dt,
        }
    return out


def bench_scaling(
    n: int = 8192,
    records: int = 65536,
    batch_size: int = 1024,
    device_counts=None,
    iters: int = 10,
    device="cuda",
    **model_kwargs,
):
    """Records/s of the sharded MSHA train step
    (:func:`~msha_gnn_torch.parallel.sharded.make_sharded_msha_step`) at
    each mesh size of ``device_counts`` (default: 1 and the process
    group's size), on a synthetic flow graph of ``ceil(n / k) k`` sources
    (32 recipients, 64 cities, 25 provinces, ``records`` records).  Every
    rank of the group calls it; size ``k`` runs on ranks ``0 .. k - 1``
    (a subgroup when ``k`` is less than the group), and the result is the
    first rank's.  Joins the process group :func:`~msha_gnn_torch.
    parallel.initialize` makes for ``device`` (a world of one without
    ``torchrun``), and destroys it after if it made it.
    ``scaling_efficiency`` is ``records_per_s`` over the first size's
    scaled by the device ratio (None for the first).  Target: >= 80%."""
    import torch.distributed as dist

    from .data import synthetic_flow
    from .parallel import initialize, make_mesh, shutdown

    made = not dist.is_initialized()
    initialize(device=device)
    try:
        world, rank = dist.get_world_size(), dist.get_rank()
        if device_counts is None:
            device_counts = sorted({1, world})
        results, base = {}, None
        for nd in device_counts:
            if nd > world:
                raise ValueError(f"{nd} devices asked for, the process "
                                 f"group has {world}")
            group = None if nd == world else dist.new_group(list(range(nd)))
            if rank < nd:
                t = _scaling_step_seconds(
                    synthetic_flow(_cdiv(n, nd) * nd, 32, 64, 25, records),
                    make_mesh(nd, group=group, device=device), batch_size,
                    iters, model_kwargs)
                rps = batch_size / t
                eff = None
                if base is None:
                    base = (nd, rps)
                else:
                    eff = rps / (base[1] * nd / base[0])
                results[str(nd)] = {"step_seconds": t,
                                    "records_per_s": rps,
                                    "scaling_efficiency": eff}
            if group is not None:
                dist.destroy_process_group(group)
        return results
    finally:
        if made:
            shutdown()


def _scaling_step_seconds(fg, mesh, batch_size, iters,
                          model_kwargs) -> float:
    """Mean seconds of one sharded MSHA step (a batch drawn from
    ``np.random.default_rng(0)``)."""
    from .parallel.sharded import make_sharded_msha_step

    step, state, _ = make_sharded_msha_step(fg, mesh, **model_kwargs)
    dev = mesh.device
    rng = np.random.default_rng(0)
    src = fg.edge_src.numpy()
    dst = fg.edge_dst.numpy()
    ids = rng.integers(0, len(src), batch_size)
    batch = torch.as_tensor(src[ids], dtype=torch.int64, device=dev)
    labels = torch.as_tensor(dst[ids], dtype=torch.int64, device=dev)
    weights = torch.ones(batch_size, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def run(batch):
        return step(state, batch, labels, weights, gen)

    return _timeit(run, batch, iters=iters)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def run_bench(which: str = "all", data_dir: str = DEFAULT_DATA_DIR,
              device="cuda"):
    """The benchmarks of ``which`` (``all``, ``flagship``, ``spmm``,
    ``sddmm``, ``size_sweep`` or ``scaling``) as one dict, under
    ``device``'s name."""
    if which not in VALID_WHICH:
        raise ValueError(f"unknown benchmark {which!r} "
                         f"({' | '.join(VALID_WHICH)})")
    out = {"device": device_name(device)}
    if which in ("all", "flagship"):
        out["flagship"] = bench_flagship(data_dir=data_dir, device=device)
    if which in ("all", "spmm"):
        out["spmm"] = bench_spmm(impl="cuda", device=device)
        out["spmm_torch"] = bench_spmm(impl="torch", device=device)
    if which in ("all", "sddmm"):
        out["sddmm"] = bench_sddmm(impl="torch", device=device)
        out["sddmm_cuda"] = bench_sddmm(impl="cuda", device=device)
    if which == "size_sweep":
        out["flagship_size_sweep"] = bench_flagship_size_sweep(device=device)
    if which == "scaling":
        out["scaling"] = bench_scaling(device=device)
    return out
