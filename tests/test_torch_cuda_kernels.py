"""The rank-1 GAT kernels and the SpMM autograd on the card.

This file imports nothing of JAX (and the tests here need no fixture of
``conftest.py``), so the card's machine, which has no JAX, runs it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py

Elsewhere the tests skip.  Inputs are U[-0.5, 0.5), the scale of the
training path's.  Tolerances: ``out`` and ``lse`` at rtol 1e-5, atol 1e-6
(float32, another summation order); ``z`` the same with atol growing as
d / 64 past d = 64, since each ``z`` holds two d-term dot products;
``dc``, ``da`` and the dx reduce, which sum many terms in another order,
at rtol 1e-4 and atol 1e-5 of the largest value.
"""

import numpy as np
import pytest
import torch

import msha_gnn_torch.graph as tg
from msha_gnn_torch.ops.cuda import rank1_gat as r1
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
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("d,rate", [(8, 0.0), (16, 0.5), (64, 0.5),
                                    (129, 0.25)])
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
    assert torch.equal(r1.keep_scale(n, seed, 0.5).cpu(),
                       r1.keep_scale_plain(torch.arange(n), -5, 0.5))


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
    w = g.weight.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="_sddmm_hub_kernel"):
        op(torch.randn(g.n_dst, 8, device="cuda"), edge_weight=w)
