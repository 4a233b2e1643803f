"""The generic rank-1 GAT's bfloat16 payload (``Rank1GatOperator(g,
precision="bf16")``, ``dst_linear=False``) against the JAX package's, on
the CPU.

The port's contract: ``x`` and ``t`` are rounded to bfloat16 (the JAX
operator casts its ``[x || t]`` rows, ``rank1_gat.py:586-592``), both
kernels (``r1_fwd_bf16``, ``r1_bwd_bf16``) read those rows, and every
logit, softmax, product and sum is float32; the cotangent stays float32,
so ``dx`` and ``dt`` are the float32 SpMMs of the JAX backward's float32
``z`` and ``dpre`` (``:744-754``).  The plain versions define that
contract exactly and are held against a float64 computation of it at
1e-6 of each result's largest value.  Against the JAX bf16 operator (its
Pallas kernels in interpret mode, which also round the unnormalised
softmax weights to bfloat16 before their MXU product) the bound is the
JAX test's own, 3e-2 (``tests/test_rank1_gat.py:85-93``), taken of the
float32 result's largest value.  The edge-run mirrors of both kernels
take bfloat16 rows on hypothesis-drawn row pointers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from msha_gnn_tpu.ops.pallas.rank1_gat import Rank1GatOperator as JaxRank1
from msha_gnn_torch.ops.cuda import flash_gat as fg
from msha_gnn_torch.ops.cuda import rank1_gat as r1
from msha_gnn_torch.ops.cuda import spmm as cuda_spmm
from tests.test_torch_fwd_runs import N_COLS, csr, pointers
from tests.test_torch_rank1_gat import dense_graph

JAX_TOL = 3e-2
EXACT = 1e-6
SLOPE = 0.2


def bf16(a) -> np.ndarray:
    """``a`` rounded to bfloat16, as float64."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).double().numpy()


def inputs(seed, n_src, n_dst, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((n_src,), (n_dst,), (n_dst, d), (n_src, d)))


def port_vjp(op, c, t, x, cot):
    ins = [torch.from_numpy(v).requires_grad_() for v in (c, t, x)]
    out = op(*ins)
    out.backward(torch.from_numpy(cot))
    return [out.detach().numpy()] + [v.grad.numpy() for v in ins]


def contract(gt, c, t, x, cot):
    """The port's generic bf16 layer in float64: ``(out, dc, dt, dx)``."""
    e = gt.num_edges
    s = gt.senders[:e].numpy().astype(np.int64)
    r = gt.receivers[:e].numpy().astype(np.int64)
    xb, tb, g = bf16(x), bf16(t), cot.astype(np.float64)
    pre = c.astype(np.float64)[s] + tb[r]
    logit = np.where(pre >= 0, pre, SLOPE * pre)
    m = np.full(gt.n_src, -np.inf)
    np.maximum.at(m, s, logit)
    p = np.exp(logit - m[s])
    den = np.zeros(gt.n_src)
    np.add.at(den, s, p)
    att = p / den[s]
    out = np.zeros((gt.n_src, x.shape[1]))
    np.add.at(out, s, att[:, None] * xb[r])
    dl = att * ((g[s] * xb[r]).sum(1) - (g * out).sum(1)[s])
    dpre = np.where(pre >= 0, dl, SLOPE * dl)
    dc, dt = np.zeros(gt.n_src), np.zeros(gt.n_dst)
    np.add.at(dc, s, dpre)
    np.add.at(dt, r, dpre)
    dx = np.zeros(x.shape)
    np.add.at(dx, r, att[:, None] * g[s])
    return out, dc, dt, dx


def counts():
    return (r1.r1_fwd_launches, r1.r1_bwd_launches, r1.r1_fwd_bf16_launches,
            r1.r1_bwd_bf16_launches, cuda_spmm.launches)


@pytest.mark.parametrize("d", [8, 32])
def test_generic_bf16_matches_jax(d):
    """Forward and ``(dc, dt, dx)`` against the JAX bf16 generic operator
    at 3e-2 of the float32 result's largest value, the forward also
    against the float32 operator; on CPU tensors nothing is launched."""
    gt, gj = dense_graph(40 + d, 300, 120, 0.05, empty_rows=(0, 151, 299))
    c, t, x, cot = inputs(d, 300, 120, d)
    jop = JaxRank1.build(gj, interpret=True, precision="bf16")
    out_j, vjp = jax.vjp(jop, jnp.asarray(c), jnp.asarray(t), jnp.asarray(x))
    want_j = [np.asarray(out_j)] + [np.asarray(v)
                                    for v in vjp(jnp.asarray(cot))]
    f32 = port_vjp(r1.Rank1GatOperator(gt), c, t, x, cot)
    before = counts()
    got = port_vjp(r1.Rank1GatOperator(gt, precision="bf16"), c, t, x, cot)
    assert counts() == before
    for what, g, j, ref in zip(("out", "dc", "dt", "dx"), got, want_j, f32):
        tol = JAX_TOL * np.abs(ref).max()
        np.testing.assert_allclose(g, j, rtol=0, atol=tol, err_msg=what)
    # the output stays near the float32 one (the gradients need not: a
    # logit near 0 whose bfloat16 t flips its leaky slope moves dc by a
    # whole 0.8 dl_e, in both packages alike)
    assert np.abs(got[0] - f32[0]).max() <= JAX_TOL * np.abs(f32[0]).max()
    assert not got[0][[0, 151, 299]].any()
    # the bf16 rows change the result: the payload is not float32
    assert not np.array_equal(got[0], f32[0])


def test_generic_bf16_operator_is_its_contract():
    """The CPU operator (the kernels' plain versions on bfloat16 rows, the
    float32 SpMMs of dx and dt) against float64 of the contract."""
    gt, _ = dense_graph(9, 150, 70, 0.08, empty_rows=(7,))
    c, t, x, cot = inputs(5, 150, 70, 16)
    got = port_vjp(r1.Rank1GatOperator(gt, precision="bf16"), c, t, x, cot)
    for what, g, want in zip(("out", "dc", "dt", "dx"), got,
                             contract(gt, c, t, x, cot)):
        np.testing.assert_allclose(g, want, rtol=EXACT,
                                   atol=EXACT * np.abs(want).max(),
                                   err_msg=what)


def test_generic_plain_versions_take_bf16_rows():
    """``rank1_gat_generic_plain`` / ``_bwd_plain`` on bfloat16 ``x`` equal
    the float32 versions on the widened rows, bit for bit."""
    gt, _ = dense_graph(12, 150, 70, 0.08, empty_rows=(7,))
    c, t, x, cot = (torch.from_numpy(v) for v in inputs(6, 150, 70, 12))
    xb = x.to(torch.bfloat16)
    op = r1.Rank1GatOperator(gt)
    args = (op.ptr, op.col, c, t)
    out, lse = r1.rank1_gat_generic_plain(*args, xb, SLOPE, 150)
    want = r1.rank1_gat_generic_plain(*args, xb.float(), SLOPE, 150)
    for g, w in zip((out, lse), want):
        assert g.dtype == torch.float32 and torch.equal(g, w)
    got = r1.rank1_gat_generic_bwd_plain(*args, xb, cot, out, lse, SLOPE,
                                         150)
    want = r1.rank1_gat_generic_bwd_plain(*args, xb.float(), cot, out, lse,
                                          SLOPE, 150)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)


def bf16_case(lengths, pad, seed, d):
    rng = np.random.default_rng(seed)
    ptr, col = csr(lengths, pad, rng)
    n_rows = len(lengths)
    c = torch.from_numpy(rng.standard_normal(n_rows).astype(np.float32))
    t = torch.from_numpy(rng.standard_normal(N_COLS).astype(np.float32))
    t = t.to(torch.bfloat16).float()   # as the operator rounds it
    x = torch.from_numpy(rng.standard_normal((N_COLS, d)).astype(
        np.float32)).to(torch.bfloat16)
    gout = torch.from_numpy(rng.standard_normal((n_rows, d)).astype(
        np.float32))
    return ptr, col, c, t, x, gout


def sums_close(got, want):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-5 * max(scale, 1.0))


@pytest.mark.parametrize("group", [2, 4])
@pytest.mark.parametrize("run", [32, 128])
def test_generic_bf16_walks_match_plain(run, group):
    """The mirrors of ``r1_fwd_bf16``'s and ``r1_bwd_bf16``'s walks on
    bfloat16 rows: every row (slot) written once, against the plain
    versions at the float32 mirrors' tolerances."""
    @settings(max_examples=6, deadline=None, database=None,
              derandomize=True)
    @given(case=pointers(run), seed=st.integers(0, 2**16),
           d=st.sampled_from([3, 8, 12]))
    def check(case, seed, d):
        lengths, pad = case
        ptr, col, c, t, x, gout = bf16_case(lengths, pad, seed, d)
        n_rows, e = len(lengths), int(ptr[-1])
        out, lse, writes = r1.rank1_gat_generic_runs_plain(
            ptr, col, c, t, x, SLOPE, n_rows, run, group)
        assert bool((writes == 1).all())
        want_out, want_lse = r1.rank1_gat_generic_plain(
            ptr, col[:e], c, t, x, SLOPE, n_rows)
        sums_close(out, want_out)
        sums_close(lse, want_lse)
        att, dpre, dc, writes, dc_writes = fg.rank1_gat_generic_bwd_runs_plain(
            ptr, col, c, t, x, gout, want_out, want_lse, SLOPE, n_rows, run,
            group)
        assert bool((writes == 1).all()) and bool((dc_writes == 1).all())
        assert not att[e:].any() and not dpre[e:].any()
        want_att, want_dpre, want_dc = r1.rank1_gat_generic_bwd_plain(
            ptr, col[:e], c, t, x, gout, want_out, want_lse, SLOPE, n_rows)
        np.testing.assert_allclose(att[:e].numpy(), want_att.numpy(),
                                   rtol=1e-5, atol=1e-7)
        sums_close(dpre[:e], want_dpre)
        sums_close(dc, want_dc)

    check()


def test_generic_bf16_rounds_t():
    """``t`` reaches the kernels rounded to bfloat16: a ``t`` that differs
    from its bfloat16 value only below bfloat16's resolution gives the
    same bits."""
    gt, _ = dense_graph(3, 60, 30, 0.2)
    c, t, x, _ = inputs(8, 60, 30, 4)
    tb = torch.from_numpy(t).to(torch.bfloat16).float()
    nudged = tb * (1 + 2.0 ** -12)
    assert not torch.equal(nudged, tb)
    op = r1.Rank1GatOperator(gt, precision="bf16")
    a = op(torch.from_numpy(c), tb, torch.from_numpy(x))
    b = op(torch.from_numpy(c), nudged, torch.from_numpy(x))
    assert torch.equal(a, b)
