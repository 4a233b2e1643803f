"""The kernels and the operators' autograd on the card.

This file imports nothing of JAX (and the tests here need no fixture of
``conftest.py``), so the card's machine, which has no JAX, runs it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py

Elsewhere the tests skip.  Inputs are U[-0.5, 0.5), the scale of the
training path's; d = 0 is a shape (the logits and the softmax statistics
do not need features).  Tolerances: ``out`` and ``lse`` at rtol 1e-5, atol 1e-6
(float32, another summation order); ``z`` the same with atol growing as
d / 64 past d = 64, since each ``z`` holds two d-term dot products;
``dc``, ``da`` and the dx reduce, which sum many terms in another order,
at rtol 1e-4 and atol 1e-5 of the largest value.  The SDDMM and the row
softmax at rtol 1e-5, atol 1e-6 (one d-term dot, or one row's exp and sum,
in another order); the softmax's VJP with the sums' tolerance.  The
flash-GAT kernels: ``out``, ``lse`` and ``q`` at rtol 1e-5, atol 1e-6;
``dl``, a difference of two d-term dots, with the sums' tolerance.
"""

import numpy as np
import pytest
import torch

import msha_gnn_torch.graph as tg
from msha_gnn_torch.ops import edge_softmax, spmm
from msha_gnn_torch.ops.cuda import flash_gat as fg
from msha_gnn_torch.ops.cuda import rank1_gat as r1
from msha_gnn_torch.ops.cuda import sddmm as cuda_sddmm
from msha_gnn_torch.ops.cuda import softmax as sm
from msha_gnn_torch.ops.cuda import spmm as cuda_spmm


def card_graph(seed, n_src, n_dst, density, empty_rows=()):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(seed)
    dense = ((rng.random((n_src, n_dst)) < density)
             * rng.integers(1, 5, (n_src, n_dst))).astype(np.float32)
    dense[list(empty_rows)] = 0.0
    return tg.BipartiteGraph.from_dense(dense, pad_to_multiple=16).to("cuda")


def sums_close(got, want):
    scale = float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("d,rate", [(0, 0.5), (8, 0.0), (16, 0.5),
                                    (64, 0.5), (129, 0.25)])
def test_rank1_kernels_match_plain(d, rate):
    g = card_graph(d, 300, 120, 0.05, empty_rows=(0, 299))
    op = r1.Rank1GatOperator(g, dst_linear=True, dropout_rate=rate)
    gen = torch.Generator(device="cuda").manual_seed(d)
    c, a, x, gout = (
        torch.rand(s, generator=gen, device="cuda") - 0.5
        for s in ((300,), (d,), (120, d), (300, d)))
    seed = torch.tensor([-5], dtype=torch.int32, device="cuda")
    args = (op.ptr, op.col, c, a, x, seed, rate, 0.2, 300)
    before = (r1.fwd_launches, r1.bwd_launches)
    out, lse = r1.r1l_fwd(*args)
    want_out, want_lse = r1.rank1_gat_plain(*args)
    bwd_args = (op.ptr, op.col, c, a, x, gout, want_out, want_lse, seed,
                rate, 0.2, 300)
    z, dc, da = r1.r1l_bwd(*bwd_args)
    wz, wdc, wda = r1.rank1_gat_bwd_plain(*bwd_args)
    torch.cuda.synchronize()
    assert (r1.fwd_launches, r1.bwd_launches) == (before[0] + 1,
                                                  before[1] + 1)
    torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(z, wz, rtol=1e-5, atol=1e-6 * max(1, d / 64))
    sums_close(dc, wdc)
    sums_close(da, wda)
    n = g.num_padded_edges
    before = r1.keep_launches
    assert torch.equal(r1.keep_scale(n, seed, 0.5).cpu(),
                       r1.keep_scale_plain(torch.arange(n), -5, 0.5))
    assert r1.keep_launches == before + 1


@pytest.mark.cuda
def test_rank1_operator_gradients_match_plain_on_card():
    """The operator's autograd on the card (kernels, then the dx reduce)
    against torch's autograd through the plain forward."""
    g = card_graph(1, 200, 90, 0.08, empty_rows=(3,))
    op = r1.Rank1GatOperator(g, dst_linear=True, dropout_rate=0.5)
    gen = torch.Generator(device="cuda").manual_seed(2)
    ins = [(torch.rand(s, generator=gen, device="cuda") - 0.5)
           .requires_grad_() for s in ((200,), (16,), (90, 16))]
    ref = [t.detach().clone().requires_grad_() for t in ins]
    seed = torch.tensor([11], dtype=torch.int32, device="cuda")
    gout = torch.randn(200, 16, generator=gen, device="cuda")
    op.drop(*ins, seed).backward(gout)
    out, _ = r1.rank1_gat_plain(op.ptr, op.col, *ref, seed, 0.5, 0.2, 200)
    out.backward(gout)
    for t, w in zip(ins, ref):
        sums_close(t.grad, w.grad)


@pytest.mark.cuda
def test_spmm_x_gradient_is_the_transposed_launch():
    g = card_graph(3, 300, 150, 0.05)
    op = cuda_spmm.SpmmOperator(g, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    for transpose in (False, True):
        n_in, n_out = (g.n_src, g.n_dst) if transpose else (g.n_dst, g.n_src)
        x = torch.randn(n_in, 8, generator=gen, device="cuda",
                        requires_grad=True)
        gout = torch.randn(n_out, 8, generator=gen, device="cuda")
        before = op.launches_transposed
        op(x, transpose=transpose).backward(gout)
        assert op.launches_transposed == before + 1
        torch.testing.assert_close(x.grad, op(gout, transpose=not transpose),
                                   rtol=1e-5, atol=1e-6)
    # the dx reduce: no weight array, read as unit weights
    z = torch.randn(op.num_edges, 16, generator=gen, device="cuda")
    before = cuda_spmm.launches
    got = op.reduce_edges(z)
    assert cuda_spmm.launches == before + 1
    want = z.new_zeros(g.n_dst, 16).index_add_(
        0, g.receivers[: op.num_edges].long(), z)
    sums_close(got, want)
    # a runtime weight's gradient is one csr_sddmm_f32 launch
    for transpose in (False, True):
        n_in, n_out = (g.n_src, g.n_dst) if transpose else (g.n_dst, g.n_src)
        x = torch.randn(n_in, 8, generator=gen, device="cuda",
                        requires_grad=True)
        w = (g.weight * 0.5).requires_grad_()
        gout = torch.randn(n_out, 8, generator=gen, device="cuda")
        before = cuda_sddmm.launches
        op(x, transpose=transpose, edge_weight=w).backward(gout)
        assert cuda_sddmm.launches == before + 1
        x_ref = x.detach().clone().requires_grad_()
        w_ref = w.detach().clone().requires_grad_()
        spmm(g, x_ref, edge_weight=w_ref, transpose=transpose,
             impl="torch").backward(gout)
        sums_close(w.grad, w_ref.grad)
        sums_close(x.grad, x_ref.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 64, 129])
def test_sddmm_kernel_matches_plain(d):
    g = card_graph(d + 1, 300, 120, 0.05, empty_rows=(0, 150, 299))
    op = cuda_spmm.SpmmOperator(g, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(d)
    a = torch.rand(300, d, generator=gen, device="cuda") - 0.5
    b = torch.rand(120, d, generator=gen, device="cuda") - 0.5
    n_out = g.num_padded_edges
    before = cuda_sddmm.launches
    got = cuda_sddmm.csr_sddmm(op.ptr, op.col, a, b, n_out)
    assert cuda_sddmm.launches == before + 1
    want = cuda_sddmm.csr_sddmm_plain(op.ptr, op.col, a, b, n_out)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert not got[op.num_edges:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("masked", ["none", "build", "arbitrary"])
def test_softmax_kernels_match_plain(masked):
    g = card_graph(7, 260, 200, 0.06, empty_rows=(0, 129, 259))
    ptr = g.row_ptr
    e, e_pad = g.num_edges, g.num_padded_edges
    mask = None
    if masked != "none":
        mask = g.edge_mask.clone()
        if masked == "arbitrary":
            gen_m = torch.Generator(device="cuda").manual_seed(3)
            mask &= torch.rand(e_pad, generator=gen_m, device="cuda") > 0.3
            mask[int(ptr[5]):int(ptr[6])] = False    # row 5 fully masked
    gen = torch.Generator(device="cuda").manual_seed(4)
    logits = torch.randn(e_pad, generator=gen, device="cuda") * 3
    gout = torch.randn(e_pad, generator=gen, device="cuda")
    # one warp, and the most: every row shorter than a block, and not
    for warps in (1, 8):
        before = (sm.fwd_launches, sm.bwd_launches)
        att, lse = sm.seg_softmax_fwd(ptr, logits, mask, e, warps)
        dl = sm.seg_softmax_bwd(ptr, att, gout, e, warps)
        assert (sm.fwd_launches, sm.bwd_launches) == (before[0] + 1,
                                                      before[1] + 1)
        want_att, want_lse = sm.seg_softmax_fwd_plain(ptr, logits, mask, e)
        want_dl = sm.seg_softmax_bwd_plain(ptr, want_att, gout, e)
        torch.cuda.synchronize()
        torch.testing.assert_close(att, want_att, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-6)
        sums_close(dl, want_dl)
        assert not att[e:].any() and not dl[e:].any()
        if mask is not None:
            assert not att[~mask].any()


@pytest.mark.cuda
def test_materialised_layer_matches_plain_on_card():
    """The materialised GAT pipeline's pieces through autograd on the
    card: the row softmax (two kernels) then the att-weighted SpMM (its
    forward, dx and dw kernels), against the plain versions."""
    g = card_graph(9, 200, 200, 0.05, empty_rows=(3,))
    gen = torch.Generator(device="cuda").manual_seed(5)
    logits = torch.randn(g.num_padded_edges, generator=gen, device="cuda")
    h = torch.rand(200, 16, generator=gen, device="cuda") - 0.5
    gout = torch.randn(200, 16, generator=gen, device="cuda")
    grads = []
    for impl in ("cuda", "torch"):
        l = logits.clone().requires_grad_()
        x = h.clone().requires_grad_()
        att = edge_softmax(g, l, impl=impl)
        spmm(g, x, edge_weight=att, impl=impl).backward(gout)
        grads.append((l.grad, x.grad))
    for got, want in zip(*grads):
        sums_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("d,rate", [(0, 0.5), (8, 0.0), (64, 0.5),
                                    (129, 0.25)])
def test_flash_kernels_match_plain(d, rate):
    """flash_fwd_f32 and flash_bwd_f32 against their plain versions, on a
    graph with empty rows and n_src not a multiple of 128: an empty row
    gets 0 and NEG, the pad slots of dl and q get 0."""
    g = card_graph(d + 2, 300, 120, 0.05, empty_rows=(0, 150, 299))
    op = fg.FlashGatOperator(g, dropout_rate=rate)
    e, e_pad = g.num_edges, g.num_padded_edges
    gen = torch.Generator(device="cuda").manual_seed(d)
    logits = torch.randn(e_pad, generator=gen, device="cuda") * 3
    x, gout = (torch.rand(s, generator=gen, device="cuda") - 0.5
               for s in ((120, d), (300, d)))
    seed = torch.tensor([-5], dtype=torch.int32, device="cuda")
    args = (op.ptr, op.col, logits, x, seed, rate, 300)
    before = (fg.fwd_launches, fg.bwd_launches)
    out, lse = fg.flash_fwd(*args)
    want_out, want_lse = fg.flash_gat_plain(*args)
    bwd_args = (op.ptr, op.col, logits, x, gout, want_out, want_lse, seed,
                rate, 300)
    # hand the caching allocator blocks full of NaN, so that a pad slot the
    # kernel does not write shows
    junk = torch.full((2, e_pad), float("nan"), device="cuda")
    del junk
    dl, q = fg.flash_bwd(*bwd_args)
    want_dl, want_q = fg.flash_gat_bwd_plain(*bwd_args)
    torch.cuda.synchronize()
    assert (fg.fwd_launches, fg.bwd_launches) == (before[0] + 1,
                                                  before[1] + 1)
    torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(q, want_q, rtol=1e-5, atol=1e-6)
    sums_close(dl, want_dl)
    assert not dl[e:].any() and not q[e:].any()
    empty = [0, 150, 299]
    assert not out[empty].any() and bool((lse[empty] == fg.NEG).all())


@pytest.mark.cuda
def test_flash_operator_gradients_match_plain_on_card():
    """The operator's autograd on the card (flash_fwd_f32, flash_bwd_f32,
    then the q-weighted transposed csr_spmm_f32 for dx) against torch's
    autograd through the plain forward."""
    g = card_graph(5, 200, 90, 0.08, empty_rows=(3,))
    op = fg.FlashGatOperator(g, dropout_rate=0.5)
    gen = torch.Generator(device="cuda").manual_seed(6)
    ins = [torch.randn(g.num_padded_edges, generator=gen,
                       device="cuda").requires_grad_(),
           (torch.rand(90, 16, generator=gen, device="cuda") - 0.5)
           .requires_grad_()]
    ref = [t.detach().clone().requires_grad_() for t in ins]
    seed = torch.tensor([11], dtype=torch.int32, device="cuda")
    gout = torch.randn(200, 16, generator=gen, device="cuda")
    before = op.spmm.launches_transposed
    op.drop(*ins, seed).backward(gout)
    assert op.spmm.launches_transposed == before + 1
    out, _ = fg.flash_gat_plain(op.ptr, op.col, *ref, seed, 0.5, 200)
    out.backward(gout)
    for t, w in zip(ins, ref):
        sums_close(t.grad, w.grad)
