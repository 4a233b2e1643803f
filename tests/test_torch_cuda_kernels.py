"""The kernels and the operators' autograd on the card.

This file imports nothing of JAX (and the tests here need no fixture of
``conftest.py``), so the card's machine, which has no JAX, runs it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py

Elsewhere the tests skip.  Inputs are U[-0.5, 0.5), the scale of the
training path's; d = 0 is a shape (the logits and the softmax statistics
do not need features).  Tolerances: ``out``, ``lse`` and ``q`` at rtol
1e-5, atol 1e-6 (float32, another summation order); ``dpre`` (a
difference of two d-term dots), ``dc``, ``da``, the SpMMs and the dx
reduce, which sum many terms in another order, at rtol 1e-4 and atol 1e-5
of the largest value.  The kernels on edge runs of slots
(``csr_spmm_f32``, ``seg_reduce_f32``, the GAT kernels and
``csr_sddmm_f32``) are also launched twice on the same inputs and must
give the same bits.  The SDDMM and the row
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
@pytest.mark.parametrize("d,rate", [(0, 0.5), (1, 0.5), (8, 0.0), (16, 0.5),
                                    (32, 0.0), (64, 0.5), (129, 0.25)])
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
    q, dpre, dc, da = r1.r1l_bwd(*bwd_args)
    wq, wdpre, wdc, wda = r1.rank1_gat_bwd_plain(*bwd_args)
    torch.cuda.synchronize()
    assert (r1.fwd_launches, r1.bwd_launches) == (before[0] + 1,
                                                  before[1] + 1)
    torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(q, wq, rtol=1e-5, atol=1e-6)
    sums_close(dpre, wdpre)
    sums_close(dc, wdc)
    sums_close(da, wda)


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
    # runs of one slot, of about a row, of many rows, and the most a warp
    # holds (the default mapping)
    for run in (1, 32, 256, 512):
        before = (sm.fwd_launches, sm.bwd_launches)
        att, lse = sm.seg_softmax_fwd(ptr, logits, mask, e, run)
        dl = sm.seg_softmax_bwd(ptr, att, gout, e, run)
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


def prime_nan(*shapes):
    """Hand the caching allocator blocks full of NaN, so that an output
    slot a kernel does not write shows."""
    junk = [torch.full(s, float("nan"), device="cuda") for s in shapes]
    del junk


SHAPES = {"rect": (300, 120), "square": (200, 200)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("d", [0, 8, 64, 129])
def test_seg_reduce_kernel_matches_plain(d, shape):
    """seg_reduce_f32 against its plain version: pad rows past the pointer
    hold NaN and are not read; empty rows give 0; d = 0 launches nothing."""
    n_src, n_dst = SHAPES[shape]
    g = card_graph(d + 3, n_src, n_dst, 0.05, empty_rows=(0, 150, n_src - 1))
    e, e_pad = g.num_edges, g.num_padded_edges
    gen = torch.Generator(device="cuda").manual_seed(d)
    values = torch.rand(e_pad, d, generator=gen, device="cuda") - 0.5
    values[e:] = float("nan")
    args = (values, g.senders, g.row_ptr)
    prime_nan((n_src, max(d, 1)))
    before = cuda_spmm.seg_launches
    got = cuda_spmm.segment_reduce_sorted(*args, n_src=n_src)
    assert cuda_spmm.seg_launches == before + (1 if d else 0)
    want = cuda_spmm.segment_reduce_sorted_plain(*args, n_src=n_src)
    torch.cuda.synchronize()
    assert got.shape == (n_src, d)
    sums_close(got, want)
    assert not got[[0, 150, n_src - 1]].any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("d", [0, 8, 64, 129, 300])
def test_spmm_dw_kernel_matches_plain_and_sddmm(d, shape):
    """csr_spmm_dw_f32 in both directions against its plain version, and
    its dw element by element against the unfused csr_sddmm_f32 (a wrong
    edge map still gives a plausible dw); pads 0 over NaN-primed blocks
    and a NaN-filled workspace; two launches bit for bit."""
    n_src, n_dst = SHAPES[shape]
    g = card_graph(d + 5, n_src, n_dst, 0.05, empty_rows=(0, 150, n_src - 1))
    op = cuda_spmm.SpmmOperator(g, device="cuda")
    e, e_pad = g.num_edges, g.num_padded_edges
    gen = torch.Generator(device="cuda").manual_seed(d)
    w = g.weight * (0.5 + torch.rand(e_pad, generator=gen, device="cuda"))
    for transpose in (False, True):
        n_in, n_out = (n_src, n_dst) if transpose else (n_dst, n_src)
        x = torch.rand(n_in, d, generator=gen, device="cuda") - 0.5
        gg = torch.rand(n_out, d, generator=gen, device="cuda") - 0.5
        if transpose:   # dx of A.T @ x walks the CSR
            args = (op.ptr, op.col, None, w, gg, x, n_src, e_pad)
        else:           # dx of A @ x walks the CSC, dw through t_edge
            args = (op.t_ptr, op.t_col, op.t_edge, w, gg, x, n_dst, e_pad)
        ws = torch.full((cuda_spmm.sums_ws_floats(e_pad, cuda_spmm.DW_RUN,
                                                d),), float("nan"),
                        device="cuda")
        prime_nan((e_pad,), (n_in, max(d, 1)))
        before = cuda_spmm.dw_launches
        dx, dw = twice_same(lambda: cuda_spmm.csr_spmm_dw(*args, ws))
        assert cuda_spmm.dw_launches == before + 2
        want_dx, want_dw = cuda_spmm.csr_spmm_dw_plain(*args)
        sums_close(dx, want_dx)
        torch.testing.assert_close(dw, want_dw, rtol=1e-5,
                                   atol=1e-6 * max(1, d / 64))
        assert not dw[e:].any()
        rows, cols = (x, gg) if transpose else (gg, x)
        sd = cuda_sddmm.csr_sddmm(op.ptr, op.col, rows, cols, e_pad)
        torch.testing.assert_close(dw, sd, rtol=1e-5,
                                   atol=1e-6 * max(1, d / 64))
        sums_close(dx, op.apply(gg, w, not transpose))


@pytest.mark.cuda
def test_spmm_dw_kernel_through_the_c_entry():
    """The C entry into NaN-filled dx, dw and workspace writes every
    element (dx rows, dw slots, the pads as 0) with the wrapper's bits; a
    graph with no edges gives dx 0 and dw 0; a bad group or run length is
    refused."""
    g = long_row_graph(300, 200, long_rows=(5,), length=900, seed=4)
    op = cuda_spmm.SpmmOperator(g, device="cuda")
    n_dw, d, run, group = g.num_padded_edges + 7, 64, 32, 8
    gen = torch.Generator(device="cuda").manual_seed(40)
    w = torch.rand(n_dw, generator=gen, device="cuda")
    gg = torch.rand(300, d, generator=gen, device="cuda") - 0.5
    x = torch.rand(200, d, generator=gen, device="cuda") - 0.5
    lib = cuda_spmm._kernel_lib()
    stream = torch.cuda.current_stream().cuda_stream
    want = cuda_spmm.csr_spmm_dw(op.t_ptr, op.t_col, op.t_edge, w, gg, x,
                                 200, n_dw, run=run, group=group)
    dx, dw, ws = (torch.full(k, float("nan"), device="cuda") for k in (
        (200, d), (n_dw,), (cuda_spmm.sums_ws_floats(n_dw, run, d),)))

    def launch(grp, rn):
        return lib.csr_spmm_dw_f32(
            op.t_ptr.data_ptr(), op.t_col.data_ptr(), op.t_edge.data_ptr(),
            w.data_ptr(), gg.data_ptr(), x.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), ws.data_ptr(), 200, n_dw, rn, grp, d, stream)

    rc = launch(group, run)
    torch.cuda.synchronize()
    assert rc == 0
    assert torch.equal(dx, want[0]) and torch.equal(dw, want[1])
    for bad_group, bad_run in ((4, run), (group, 0)):
        assert launch(bad_group, bad_run) != 0
    zero_ptr = torch.zeros(7, dtype=torch.int32, device="cuda")
    none = torch.zeros(0, dtype=torch.int32, device="cuda")
    for pads in (0, 50):
        prime_nan((6, d), (pads,))
        dx0, dw0 = cuda_spmm.csr_spmm_dw(
            zero_ptr, none, None, w, gg, x[:6], 6, pads)
        torch.cuda.synchronize()
        assert not dx0.any() and not dw0.any() and dw0.numel() == pads


@pytest.mark.cuda
def test_spmm_fused_bwd_is_one_dw_launch():
    """SpmmOperator(fused_bwd=True): one csr_spmm_dw_f32 launch per
    backward and no csr_sddmm_f32, with the unfused operator's dx and dw."""
    g = card_graph(11, 300, 150, 0.05, empty_rows=(3,))
    ops = {f: cuda_spmm.SpmmOperator(g, device="cuda", fused_bwd=f)
           for f in (False, True)}
    gen = torch.Generator(device="cuda").manual_seed(11)
    # the operator's workspace, NaN before each backward
    ops[True]._dw_ws = torch.full(
        (cuda_spmm.sums_ws_floats(g.num_padded_edges, cuda_spmm.DW_RUN, 16),),
        float("nan"), device="cuda")
    for transpose in (False, True):
        ops[True]._dw_ws.fill_(float("nan"))
        n_in, n_out = (g.n_src, g.n_dst) if transpose else (g.n_dst, g.n_src)
        x0 = torch.rand(n_in, 16, generator=gen, device="cuda") - 0.5
        w0 = g.weight * torch.rand(g.num_padded_edges, generator=gen,
                                   device="cuda")
        gout = torch.randn(n_out, 16, generator=gen, device="cuda")
        grads = {}
        for fused, op in ops.items():
            x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
            out = op(x, transpose=transpose, edge_weight=w)
            before = (cuda_spmm.dw_launches, cuda_sddmm.launches,
                      cuda_spmm.launches)
            out.backward(gout)
            after = (cuda_spmm.dw_launches, cuda_sddmm.launches,
                     cuda_spmm.launches)
            assert [b - a for a, b in zip(before, after)] == (
                [1, 0, 0] if fused else [0, 1, 1])
            grads[fused] = (x.grad, w.grad)
        for got, want in zip(grads[True], grads[False]):
            sums_close(got, want)
        assert not grads[True][1][g.num_edges:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("d", [0, 8, 64, 129])
def test_rank1_generic_kernels_match_plain(d, shape):
    """r1_fwd_f32 and r1_bwd_f32 against their plain versions: an empty row
    gets 0 and NEG and contributes nothing; every slot of att and dpre is
    written over NaN-primed blocks."""
    n_src, n_dst = SHAPES[shape]
    g = card_graph(d + 7, n_src, n_dst, 0.05, empty_rows=(0, 150, n_src - 1))
    op = r1.Rank1GatOperator(g)
    e = g.num_edges
    gen = torch.Generator(device="cuda").manual_seed(d)
    c = (torch.rand(n_src, generator=gen, device="cuda") - 0.5) * 4
    t = (torch.rand(n_dst, generator=gen, device="cuda") - 0.5) * 4
    x = torch.rand(n_dst, d, generator=gen, device="cuda") - 0.5
    gout = torch.rand(n_src, d, generator=gen, device="cuda") - 0.5
    args = (op.ptr, op.col, c, t, x, 0.2, n_src)
    before = (r1.r1_fwd_launches, r1.r1_bwd_launches)
    prime_nan((n_src, max(d, 1)), (n_src,))
    out, lse = r1.r1_fwd(*args)
    want_out, want_lse = r1.rank1_gat_generic_plain(*args)
    bwd_args = (op.ptr, op.col, c, t, x, gout, want_out, want_lse, 0.2,
                n_src)
    prime_nan((e,), (e,), (n_src,))
    att, dpre, dc = r1.r1_bwd(*bwd_args)
    want_att, want_dpre, want_dc = r1.rank1_gat_generic_bwd_plain(*bwd_args)
    torch.cuda.synchronize()
    assert (r1.r1_fwd_launches, r1.r1_bwd_launches) == (before[0] + 1,
                                                        before[1] + 1)
    torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(att, want_att, rtol=1e-5, atol=1e-6)
    sums_close(dpre, want_dpre)
    sums_close(dc, want_dc)
    empty = [0, 150, n_src - 1]
    assert not out[empty].any() and bool((lse[empty] == r1.NEG).all())
    assert not dc[empty].any()


@pytest.mark.cuda
def test_rank1_generic_operator_gradients_match_plain_on_card():
    """The generic operator's autograd on the card (r1_fwd_f32, r1_bwd_f32,
    then the att-weighted transposed csr_spmm_f32 for dx and the dpre
    reduce for dt) against torch's autograd through the plain forward, and
    the dst_linear operator's through da = x^T dt, dx_lin = dx + dt a^T."""
    g = card_graph(13, 200, 90, 0.08, empty_rows=(3,))
    op = r1.Rank1GatOperator(g)
    gen = torch.Generator(device="cuda").manual_seed(13)
    c = torch.rand(200, generator=gen, device="cuda") - 0.5
    a = (torch.rand(16, generator=gen, device="cuda") - 0.5) * 0.6
    x = torch.rand(90, 16, generator=gen, device="cuda") - 0.5
    gout = torch.randn(200, 16, generator=gen, device="cuda")
    ins = [v.clone().requires_grad_() for v in (c, x @ a, x)]
    ref = [v.detach().clone().requires_grad_() for v in ins]
    before = (r1.r1_fwd_launches, r1.r1_bwd_launches, cuda_spmm.launches)
    out = op(*ins)
    out.backward(gout)
    assert (r1.r1_fwd_launches, r1.r1_bwd_launches, cuda_spmm.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 2)
    want, _ = r1.rank1_gat_generic_plain(op.ptr, op.col, *ref, 0.2, 200)
    want.backward(gout)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    for v, w in zip(ins, ref):
        sums_close(v.grad, w.grad)
    lin = [v.clone().requires_grad_() for v in (c, a, x)]
    out_lin = r1.Rank1GatOperator(g, dst_linear=True)(*lin)
    out_lin.backward(gout)
    torch.testing.assert_close(out, out_lin, rtol=1e-5, atol=1e-6)
    dc, dt, dx = (v.grad for v in ins)
    sums_close(dc, lin[0].grad)
    sums_close(x.T @ dt, lin[1].grad)
    sums_close(dx + dt[:, None] * a[None, :], lin[2].grad)


def long_row_graph(n_src, n_dst, long_rows=(1,), length=700, seed=0):
    """A graph whose ``long_rows`` hold ``length`` edges each (to n_dst
    columns, so repeated columns), beside rows of a few edges and empty
    rows (0, the middle one and the last)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 6, n_src)
    lengths[[0, n_src // 2, n_src - 1]] = 0
    lengths[list(long_rows)] = length
    src = np.repeat(np.arange(n_src), lengths)
    dst = rng.integers(0, n_dst, src.size)
    w = (rng.random(src.size) + 0.5).astype(np.float32)
    return tg.BipartiteGraph.from_coo(src, dst, w, n_src=n_src, n_dst=n_dst,
                                      pad_to_multiple=16).to("cuda")


def twice_same(fn):
    """``fn()`` launched twice gives the same bits; returns the first."""
    first = fn()
    second = fn()
    torch.cuda.synchronize()
    firsts = first if isinstance(first, tuple) else (first,)
    seconds = second if isinstance(second, tuple) else (second,)
    for u, v in zip(firsts, seconds):
        assert torch.equal(u, v), "two launches differ"
    return first


RUNS = [None, 1, 32, 256]


@pytest.mark.cuda
@pytest.mark.parametrize("run", RUNS, ids=lambda r: f"run{r}")
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("d", [1, 8, 32, 64, 129])
def test_spmm_runs_kernel_matches_plain(d, shape, run):
    """csr_spmm_f32 (weighted, unweighted, both directions) against its
    plain version on a graph with long rows that cross many runs, empty
    rows and empty columns, over NaN-primed outputs, twice bit for bit."""
    n_src, n_dst = SHAPES[shape]
    g = long_row_graph(n_src, n_dst, long_rows=(1, n_src - 2), seed=d)
    op = cuda_spmm.SpmmOperator(g, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(d)
    for transpose in (False, True):
        n_in, n_out = (n_src, n_dst) if transpose else (n_dst, n_src)
        ptr, col, w = ((op.t_ptr, op.t_col, op.t_w) if transpose
                       else (op.ptr, op.col, op.w))
        x = torch.rand(n_in, d, generator=gen, device="cuda") - 0.5
        for ww in (w, None):
            prime_nan((n_out, d), (2 * n_out * d,))
            before = cuda_spmm.launches
            got = twice_same(lambda: cuda_spmm.csr_spmm(ptr, col, ww, x,
                                                        n_out, run))
            assert cuda_spmm.launches == before + 2
            want = cuda_spmm.csr_spmm_plain(ptr, col, ww, x, n_out)
            assert got.shape == (n_out, d)
            sums_close(got, want)
    # the schedule's mirror computes the same function
    x = torch.rand(n_dst, d, generator=gen, device="cuda") - 0.5
    mirror, writes = cuda_spmm.csr_spmm_runs_plain(
        op.ptr.cpu(), op.col.cpu(), op.w.cpu(), x.cpu(), n_src,
        run or cuda_spmm.run_for(op.num_edges, d))
    assert bool((writes == 1).all())
    sums_close(cuda_spmm.csr_spmm(op.ptr, op.col, op.w, x, n_src, run).cpu(),
               mirror)


@pytest.mark.cuda
@pytest.mark.parametrize("run", RUNS, ids=lambda r: f"run{r}")
@pytest.mark.parametrize("d", [1, 32, 64])
def test_seg_reduce_runs_kernel_matches_plain(d, run):
    """seg_reduce_f32 over a pointer with long rows, empty rows and NaN pad
    rows, at several run lengths, twice bit for bit."""
    g = long_row_graph(300, 120, long_rows=(1, 298), seed=d + 1)
    e, e_pad = g.num_edges, g.num_padded_edges
    gen = torch.Generator(device="cuda").manual_seed(d)
    values = torch.rand(e_pad + 40, d, generator=gen, device="cuda") - 0.5
    values[e:] = float("nan")
    senders = torch.cat([g.senders, torch.full((40,), 300, device="cuda",
                                               dtype=g.senders.dtype)])
    prime_nan((300, d))
    got = twice_same(lambda: cuda_spmm.segment_reduce_sorted(
        values, senders, g.row_ptr, n_src=300, run=run))
    want = cuda_spmm.segment_reduce_sorted_plain(values, senders, g.row_ptr,
                                                 n_src=300)
    sums_close(got, want)
    assert not got[[0, 150, 299]].any()


def hub_pointer(hub=2_000_000, n_rows=3_000, n_cols=500, seed=0):
    """A CSR pointer (int32, on the card) of one ``hub``-slot row (row
    1,500) among rows of 0 to 5 slots (rows 0, 1,499 and the last empty),
    and columns drawn over ``n_cols``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 6, n_rows)
    lengths[[0, n_rows // 2 - 1, n_rows - 1]] = 0
    lengths[n_rows // 2] = hub
    ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    col = rng.integers(0, n_cols, int(ptr[-1])).astype(np.int32)
    return (torch.from_numpy(ptr).cuda(), torch.from_numpy(col).cuda(),
            n_rows, n_cols)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 32, 64])
def test_sums_of_a_hub_row_match_float64(d):
    """A 2 M-slot row among short and empty rows, whose crossing pieces
    the fix-up adds over about 62,500 runs (d = 1) or 7,800 (d > 1): the
    sums of csr_spmm_f32, seg_reduce_f32 and csr_spmm_dw_f32 against
    float64 sums at the sums' tolerance, over NaN-primed outputs (every row
    written), twice bit for bit; the kernels' chunk of runs is the
    workspace's."""
    ptr, col, n_rows, n_cols = hub_pointer(seed=d)
    e = col.numel()
    assert (cuda_spmm._kernel_lib().csr_fix_chunk_runs(d)
            == cuda_spmm.chunk_runs(d))
    gen = torch.Generator(device="cuda").manual_seed(d)
    w = torch.rand(e, generator=gen, device="cuda") + 0.5
    x = torch.rand(n_cols, d, generator=gen, device="cuda") - 0.5
    ws = cuda_spmm.sums_ws_floats(e, cuda_spmm.run_for(e, d), d)
    prime_nan((n_rows, d), (ws,))
    got = twice_same(lambda: cuda_spmm.csr_spmm(ptr, col, w, x, n_rows))
    assert not got.isnan().any()
    sums_close(got.double(), cuda_spmm.csr_spmm_plain(
        ptr, col, w.double(), x.double(), n_rows))

    values = torch.rand(e + 8, d, generator=gen, device="cuda") - 0.5
    values[e:] = float("nan")
    prime_nan((n_rows, d), (ws,))
    got = twice_same(lambda: cuda_spmm.row_sums(values, ptr, n_rows=n_rows))
    assert not got.isnan().any()
    sums_close(got.double(), cuda_spmm.segment_reduce_sorted_plain(
        values.double(), None, ptr, n_src=n_rows))
    del values

    g = torch.rand(n_cols, d, generator=gen, device="cuda") - 0.5
    xr = torch.rand(n_rows, d, generator=gen, device="cuda") - 0.5
    prime_nan((n_rows, d), (e,),
              (cuda_spmm.sums_ws_floats(e, cuda_spmm.DW_RUN, d),))
    dx, dw = twice_same(lambda: cuda_spmm.csr_spmm_dw(
        ptr, col, None, w, g, xr, n_rows, e))
    assert not dx.isnan().any() and not dw.isnan().any()
    want_dx, want_dw = cuda_spmm.csr_spmm_dw_plain(
        ptr, col, None, w.double(), g.double(), xr.double(), n_rows, e)
    sums_close(dx.double(), want_dx)
    torch.testing.assert_close(dw.double(), want_dw, rtol=1e-5,
                               atol=1e-6 * max(1, d / 64))


@pytest.mark.cuda
def test_spmm_runs_kernel_with_no_edges():
    """A graph without edges: every row written as 0, at d 1 and d 64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dense = np.zeros((40, 9), np.float32)
    g = tg.BipartiteGraph.from_dense(dense, pad_to_multiple=16).to("cuda")
    op = cuda_spmm.SpmmOperator(g, device="cuda")
    for d in (1, 64):
        prime_nan((40, d), (2 * 40 * d,))
        x = torch.ones(9, d, device="cuda")
        assert not op(x).any()
        assert not op(torch.ones(40, d, device="cuda"), transpose=True).any()


@pytest.mark.cuda
@pytest.mark.parametrize("run", RUNS, ids=lambda r: f"run{r}")
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("d", [0, 1, 8, 32, 64, 129])
def test_rank1_bwd_runs_kernel_matches_plain(d, shape, run):
    """r1l_bwd_f32 at dropout 0.5 on a graph with rows longer than a run,
    empty rows and a square or rectangular shape: q, dpre, dc and da
    against the plain backward over NaN-primed blocks, twice bit for bit,
    and the operator's dx (assembled from q and dpre) against the plain
    autograd."""
    n_src, n_dst = SHAPES[shape]
    g = long_row_graph(n_src, n_dst, long_rows=(1, n_src - 2), length=600,
                       seed=d + 2)
    op = r1.Rank1GatOperator(g, dst_linear=True, dropout_rate=0.5)
    gen = torch.Generator(device="cuda").manual_seed(d)
    c = torch.rand(n_src, generator=gen, device="cuda") - 0.5
    a = (torch.rand(d, generator=gen, device="cuda") - 0.5) * 0.5
    x = torch.rand(n_dst, d, generator=gen, device="cuda") - 0.5
    gout = torch.rand(n_src, d, generator=gen, device="cuda") - 0.5
    seed = torch.tensor([77], dtype=torch.int32, device="cuda")
    out, lse = r1.rank1_gat_plain(op.ptr, op.col, c, a, x, seed, 0.5, 0.2,
                                  n_src)
    args = (op.ptr, op.col, c, a, x, gout, out, lse, seed, 0.5, 0.2, n_src)
    e = op.col.numel()
    prime_nan((e,), (e,), (n_src,), (e * (2 + d),))
    q, dpre, dc, da = twice_same(lambda: r1.r1l_bwd(*args, run=run))
    wq, wdpre, wdc, wda = r1.rank1_gat_bwd_plain(*args)
    torch.testing.assert_close(q, wq, rtol=1e-5, atol=1e-6)
    sums_close(dpre, wdpre)
    sums_close(dc, wdc)
    sums_close(da, wda)
    empty = [0, n_src // 2, n_src - 1]
    assert not dc[empty].any()
    if d:
        ins = [v.clone().requires_grad_() for v in (c, a, x)]
        op.drop(*ins, seed).backward(gout)
        ref = [v.clone().requires_grad_() for v in (c, a, x)]
        r1.rank1_gat_plain(op.ptr, op.col, *ref, seed, 0.5, 0.2,
                           n_src)[0].backward(gout)
        for u, v in zip(ins, ref):
            sums_close(u.grad, v.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("run", [None, 32], ids=lambda r: f"run{r}")
@pytest.mark.parametrize("d", [1, 64])
def test_rank1_bwd_reads_its_edge_count_from_ptr(d, run):
    """r1l_bwd_f32 given a ``col`` padded past ``ptr[n_rows]`` (as a
    graph's padded receivers are): the pads of q and dpre come out 0 over
    NaN-primed memory, and q, dpre, dc and da on the edges are those of
    the unpadded call."""
    g = long_row_graph(200, 90, long_rows=(1,), length=600, seed=d)
    op = r1.Rank1GatOperator(g, dst_linear=True, dropout_rate=0.5)
    gen = torch.Generator(device="cuda").manual_seed(d)
    c = torch.rand(200, generator=gen, device="cuda") - 0.5
    a = torch.rand(d, generator=gen, device="cuda") - 0.5
    x = torch.rand(90, d, generator=gen, device="cuda") - 0.5
    gout = torch.rand(200, d, generator=gen, device="cuda") - 0.5
    seed = torch.tensor([9], dtype=torch.int32, device="cuda")
    out, lse = r1.rank1_gat_plain(op.ptr, op.col, c, a, x, seed, 0.5, 0.2,
                                  200)
    e = op.col.numel()
    padded = torch.cat([op.col, torch.full((300,), 89, dtype=op.col.dtype,
                                           device="cuda")])
    rest = (c, a, x, gout, out, lse, seed, 0.5, 0.2, 200)
    prime_nan((e + 300,), (e + 300,), (200,), ((e + 300) * (3 + d),))
    q, dpre, dc, da = twice_same(lambda: r1.r1l_bwd(op.ptr, padded, *rest,
                                                    run=run))
    assert not q[e:].any() and not dpre[e:].any()
    wq, wdpre, wdc, wda = r1.rank1_gat_bwd_plain(op.ptr, op.col, *rest)
    torch.testing.assert_close(q[:e], wq, rtol=1e-5, atol=1e-6)
    sums_close(dpre[:e], wdpre)
    sums_close(dc, wdc)
    sums_close(da, wda)


@pytest.mark.cuda
def test_dst_linear_backward_counts_its_two_dx_launches():
    """One dst_linear backward launches r1l_bwd_f32 once and two
    transposed csr_spmm_f32: the q-weighted dx and the d = 1 column sum of
    dpre, the one counted in ``launches_reduce``."""
    g = card_graph(4, 200, 90, 0.08, empty_rows=(3,))
    op = r1.Rank1GatOperator(g, dst_linear=True)
    gen = torch.Generator(device="cuda").manual_seed(4)
    ins = [(torch.rand(s, generator=gen, device="cuda") - 0.5)
           .requires_grad_() for s in ((200,), (16,), (90, 16))]
    out = op(*ins)
    spmm_op = op.spmm
    before = (r1.bwd_launches, spmm_op.launches,
              spmm_op.launches_transposed, spmm_op.launches_reduce)
    out.backward(torch.ones_like(out))
    torch.cuda.synchronize()
    after = (r1.bwd_launches, spmm_op.launches,
             spmm_op.launches_transposed, spmm_op.launches_reduce)
    assert [v - u for u, v in zip(before, after)] == [1, 2, 2, 1]


@pytest.mark.cuda
def test_rectangular_gat_layer_impls_match_torch_on_card():
    """SparseGATLayer(graph, x_src, x_dst) on a 30 x 12 graph: fused,
    materialised and flash against impl="torch", in training (the same
    keep masks from one generator state) and in evaluation, outputs and
    gradients."""
    from msha_gnn_torch.models import SparseGATLayer

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    keys = rng.choice(29 * 11, 100, replace=False)
    g = tg.BipartiteGraph.from_coo(keys // 11 + 1, keys % 11,
                                   np.ones(100, np.float32), n_src=30,
                                   n_dst=12, pad_to_multiple=16).to("cuda")
    layer = SparseGATLayer(6, 8, dropout=0.5,
                           generator=torch.Generator().manual_seed(1))
    layer = layer.to("cuda")
    x_src = torch.from_numpy(rng.standard_normal((30, 6)).astype(
        np.float32)).cuda()
    x_dst = torch.from_numpy(rng.standard_normal((12, 6)).astype(
        np.float32)).cuda()
    gout = torch.from_numpy(rng.standard_normal((30, 8)).astype(
        np.float32)).cuda()
    for train in (False, True):
        got = {}
        for impl in ("torch", "fused", "materialised", "flash"):
            layer.zero_grad()
            xs = x_src.clone().requires_grad_()
            xd = x_dst.clone().requires_grad_()
            gen = torch.Generator(device="cuda").manual_seed(5)
            out = layer(g, xs, xd, train=train, impl=impl, generator=gen)
            out.backward(gout)
            got[impl] = (out.detach(), xs.grad, xd.grad, layer.W.grad.clone(),
                         layer.a.grad.clone())
        for impl in ("fused", "materialised", "flash"):
            torch.testing.assert_close(got[impl][0], got["torch"][0],
                                       rtol=1e-5, atol=1e-6)
            for u, v in zip(got[impl][1:], got["torch"][1:]):
                sums_close(u, v)


# the edge-run GAT kernels: every run length the wrappers may pick, and run 1
# (every slot a run, so each row crosses runs), at each group of lanes
EDGE_RUNS = [None, 1, *cuda_spmm.RUN_SLOTS]


def rank1_inputs(g, n_src, n_dst, d, seed, scale=1.0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = (torch.rand(n_src, generator=gen, device="cuda") - 0.5) * scale
    a = (torch.rand(d, generator=gen, device="cuda") - 0.5) * 0.5 * scale
    x = torch.rand(n_dst, d, generator=gen, device="cuda") - 0.5
    return c, a, x


@pytest.mark.cuda
@pytest.mark.parametrize("group", r1.GROUPS, ids=lambda g: f"group{g}")
@pytest.mark.parametrize("run", EDGE_RUNS, ids=lambda r: f"run{r}")
@pytest.mark.parametrize("d", [1, 64, 129])
def test_rank1_fwd_runs_kernel_matches_plain(d, run, group):
    """r1l_fwd_f32 at dropout 0 and 0.5 on a graph with rows longer than
    many runs and empty rows (first, middle, last): out and lse against
    the plain forward over NaN-primed blocks, twice bit for bit, empty rows
    0 and NEG; the same with the logits x30; and against the schedule's
    mirror."""
    g = long_row_graph(300, 120, long_rows=(1, 298), length=600, seed=d + 3)
    op = r1.Rank1GatOperator(g, dst_linear=True)
    empty = [0, 150, 299]
    seed = torch.tensor([-77], dtype=torch.int32, device="cuda")
    for scale in (1.0, 30.0):
        c, a, x = rank1_inputs(g, 300, 120, d, d, scale)
        for rate in (0.0, 0.5):
            args = (op.ptr, op.col, c, a, x, seed, rate, 0.2, 300)
            prime_nan((300, d), (300,), (2 * 300 * (2 * d + 5),))
            before = r1.fwd_launches
            out, lse = twice_same(lambda: r1.r1l_fwd(*args, run=run,
                                                     group=group))
            assert r1.fwd_launches == before + 2
            want_out, want_lse = r1.rank1_gat_plain(*args)
            torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-6)
            assert not out[empty].any()
            assert bool((lse[empty] == r1.NEG).all())
    cpu = [v.cpu() for v in (op.ptr, op.col, c, a, x, seed)]
    mirror, mirror_lse, writes = r1.rank1_gat_runs_plain(
        *cpu, 0.5, 0.2, 300, run or cuda_spmm.warp_run(op.col.numel()),
        group)
    assert bool((writes == 1).all())
    sums_close(out.cpu(), mirror)
    sums_close(lse.cpu(), mirror_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("group", r1.GROUPS, ids=lambda g: f"group{g}")
@pytest.mark.parametrize("run", EDGE_RUNS, ids=lambda r: f"run{r}")
def test_rank1_fwd_runs_kernel_on_small_graph(run, group):
    """r1l_fwd_f32 on the 300 x 120 graph with empty rows, d 0, 8 and 64,
    and with its col padded past ptr[n_rows]: the pads change no bit."""
    g = card_graph(run or 7, 300, 120, 0.05, empty_rows=(0, 150, 299))
    op = r1.Rank1GatOperator(g, dst_linear=True)
    seed = torch.tensor([5], dtype=torch.int32, device="cuda")
    padded = torch.cat([op.col, torch.full((300,), 119, dtype=op.col.dtype,
                                           device="cuda")])
    for d in (0, 8, 64):
        c, a, x = rank1_inputs(g, 300, 120, d, d + 1)
        for rate in (0.0, 0.5):
            rest = (c, a, x, seed, rate, 0.2, 300)
            prime_nan((300, d), (300,))
            out, lse = twice_same(lambda: r1.r1l_fwd(
                op.ptr, op.col, *rest, run=run, group=group))
            want_out, want_lse = r1.rank1_gat_plain(op.ptr, op.col, *rest)
            torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-6)
            assert not out[[0, 150, 299]].any()
            assert bool((lse[[0, 150, 299]] == r1.NEG).all())
            # a padded col adds runs past the last edge and nothing else
            prime_nan((300, d), (300,))
            out_p, lse_p = r1.r1l_fwd(op.ptr, padded, *rest, run=run,
                                      group=group)
            assert torch.equal(out_p, out) and torch.equal(lse_p, lse)


@pytest.mark.cuda
@pytest.mark.parametrize("group", r1.GROUPS, ids=lambda g: f"group{g}")
@pytest.mark.parametrize("run", EDGE_RUNS, ids=lambda r: f"run{r}")
@pytest.mark.parametrize("d", [0, 1, 64, 129])
def test_flash_bwd_runs_kernel_matches_plain(d, run, group):
    """flash_bwd_f32 at dropout 0.5 (and 0 at d 64) on a graph with rows
    longer than many runs and empty rows, with pad slots past ptr[n_rows]
    and a padded col: dl and q against the plain backward over NaN-primed
    blocks, twice bit for bit, pads 0, q 0 exactly on the dropped slots;
    the same with the logits x30; and against the walk's mirror."""
    g = long_row_graph(300, 120, long_rows=(1, 298), length=600, seed=d + 4)
    op = fg.FlashGatOperator(g)
    e, e_pad = g.num_edges, g.num_padded_edges + 40
    gen = torch.Generator(device="cuda").manual_seed(d)
    x = torch.rand(120, d, generator=gen, device="cuda") - 0.5
    gout = torch.rand(300, d, generator=gen, device="cuda") - 0.5
    base = torch.randn(e_pad, generator=gen, device="cuda") * 3
    padded = torch.cat([op.col, torch.zeros(40, dtype=op.col.dtype,
                                            device="cuda")])
    seed = torch.tensor([31], dtype=torch.int32, device="cuda")
    keep = r1.keep_scale_plain(torch.arange(e, device="cuda"), seed, 0.5)
    for logits in (base, base * 30):
        for rate in ((0.0, 0.5) if d == 64 else (0.5,)):
            out, lse = fg.flash_gat_plain(op.ptr, op.col, logits, x, seed,
                                          rate, 300)
            rest = (logits, x, gout, out, lse, seed, rate, 300)
            prime_nan((2, e_pad))
            before = fg.bwd_launches
            dl, q = twice_same(lambda: fg.flash_bwd(op.ptr, op.col, *rest,
                                                    run=run, group=group))
            assert fg.bwd_launches == before + 2
            want_dl, want_q = fg.flash_gat_bwd_plain(op.ptr, op.col, *rest)
            torch.testing.assert_close(q, want_q, rtol=1e-5, atol=1e-6)
            sums_close(dl, want_dl)
            assert not dl[e:].any() and not q[e:].any()
            if rate:
                dropped = keep == 0
                assert not q[:e][dropped].any()
                assert bool((q[:e][~dropped & (want_q[:e] > 1e-30)]
                             > 0).all())
            prime_nan((2, e_pad))
            dl_p, q_p = fg.flash_bwd(op.ptr, padded, *rest, run=run,
                                     group=group)
            assert torch.equal(dl_p, dl) and torch.equal(q_p, q)
    cpu = [v.cpu() for v in (op.ptr, op.col, *rest[:6])]
    mirror_dl, mirror_q, writes = fg.flash_gat_bwd_runs_plain(
        *cpu, rate, 300, run or fg.BWD_RUN, group)
    assert bool((writes == 1).all())
    sums_close(dl.cpu(), mirror_dl)
    torch.testing.assert_close(q.cpu(), mirror_q, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("group", r1.GROUPS, ids=lambda g: f"group{g}")
@pytest.mark.parametrize("run", EDGE_RUNS, ids=lambda r: f"run{r}")
@pytest.mark.parametrize("d", [0, 1, 64, 129])
def test_flash_fwd_runs_kernel_matches_plain(d, run, group):
    """flash_fwd_f32 at dropout 0 and 0.5 on a graph with rows longer than
    many runs and empty rows (first, middle, last): out and lse against
    the plain forward over NaN-primed blocks, twice bit for bit, empty rows
    0 and NEG; the same with the logits x30; a col padded past ptr[n_rows]
    changes no bit; and against the walk's mirror."""
    g = long_row_graph(300, 120, long_rows=(1, 298), length=600, seed=d + 5)
    op = fg.FlashGatOperator(g)
    empty = [0, 150, 299]
    gen = torch.Generator(device="cuda").manual_seed(d)
    x = torch.rand(120, d, generator=gen, device="cuda") - 0.5
    base = torch.randn(g.num_padded_edges + 40, generator=gen,
                       device="cuda") * 3
    padded = torch.cat([op.col, torch.full((40,), 119, dtype=op.col.dtype,
                                           device="cuda")])
    seed = torch.tensor([-77], dtype=torch.int32, device="cuda")
    for logits in (base, base * 30):
        for rate in (0.0, 0.5):
            args = (op.ptr, op.col, logits, x, seed, rate, 300)
            prime_nan((300, max(d, 1)), (300,), (2 * 300 * (2 * d + 5),))
            before = fg.fwd_launches
            out, lse = twice_same(lambda: fg.flash_fwd(*args, run=run,
                                                       group=group))
            assert fg.fwd_launches == before + 2
            want_out, want_lse = fg.flash_gat_plain(*args)
            torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-6)
            assert not out[empty].any()
            assert bool((lse[empty] == fg.NEG).all())
            prime_nan((300, max(d, 1)), (300,))
            out_p, lse_p = fg.flash_fwd(op.ptr, padded, *args[2:], run=run,
                                        group=group)
            assert torch.equal(out_p, out) and torch.equal(lse_p, lse)
    cpu = [v.cpu() for v in (op.ptr, op.col, logits, x, seed)]
    mirror, mirror_lse, writes = fg.flash_gat_runs_plain(
        *cpu, 0.5, 300, run or cuda_spmm.warp_run(op.col.numel()), group)
    assert bool((writes == 1).all())
    sums_close(out.cpu(), mirror)
    sums_close(lse.cpu(), mirror_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("group", r1.GROUPS, ids=lambda g: f"group{g}")
@pytest.mark.parametrize("run", EDGE_RUNS, ids=lambda r: f"run{r}")
@pytest.mark.parametrize("d", [0, 1, 64, 129])
def test_r1_fwd_runs_kernel_matches_plain(d, run, group):
    """r1_fwd_f32 on a graph with rows longer than many runs and empty rows:
    out and lse against the plain generic forward over NaN-primed blocks,
    twice bit for bit, empty rows 0 and NEG; the same with c and t x30; a
    padded col changes no bit; and against the walk's mirror."""
    g = long_row_graph(300, 120, long_rows=(1, 298), length=600, seed=d + 6)
    op = r1.Rank1GatOperator(g)
    empty = [0, 150, 299]
    padded = torch.cat([op.col, torch.zeros(40, dtype=op.col.dtype,
                                            device="cuda")])
    for scale in (1.0, 30.0):
        c, _, x = rank1_inputs(g, 300, 120, d, d + 9, scale)
        gen = torch.Generator(device="cuda").manual_seed(d + 10)
        t = (torch.rand(120, generator=gen, device="cuda") - 0.5) * scale
        args = (op.ptr, op.col, c, t, x, 0.2, 300)
        prime_nan((300, max(d, 1)), (300,), (2 * 300 * (2 * d + 5),))
        before = r1.r1_fwd_launches
        out, lse = twice_same(lambda: r1.r1_fwd(*args, run=run, group=group))
        assert r1.r1_fwd_launches == before + 2
        want_out, want_lse = r1.rank1_gat_generic_plain(*args)
        torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-6)
        assert not out[empty].any()
        assert bool((lse[empty] == r1.NEG).all())
        prime_nan((300, max(d, 1)), (300,))
        out_p, lse_p = r1.r1_fwd(op.ptr, padded, *args[2:], run=run,
                                 group=group)
        assert torch.equal(out_p, out) and torch.equal(lse_p, lse)
    cpu = [v.cpu() for v in (op.ptr, op.col, c, t, x)]
    mirror, mirror_lse, writes = r1.rank1_gat_generic_runs_plain(
        *cpu, 0.2, 300, run or cuda_spmm.warp_run(op.col.numel()), group)
    assert bool((writes == 1).all())
    sums_close(out.cpu(), mirror)
    sums_close(lse.cpu(), mirror_lse)


@pytest.mark.cuda
def test_one_block_per_row_gat_kernels_still_match_plain():
    """r1_bwd_f32, the last GAT kernel that ran one block per row (now the
    per-edge walk of gat_bwd.cuh), at its default run and group: against
    its plain version on a graph with a long row and empty rows, at d 64,
    on the plain forward's out and lse."""
    g = long_row_graph(300, 120, long_rows=(1,), length=600, seed=9)
    op = r1.Rank1GatOperator(g)
    gen = torch.Generator(device="cuda").manual_seed(9)
    c = torch.rand(300, generator=gen, device="cuda") - 0.5
    t = torch.rand(120, generator=gen, device="cuda") - 0.5
    x = torch.rand(120, 64, generator=gen, device="cuda") - 0.5
    gout = torch.rand(300, 64, generator=gen, device="cuda") - 0.5
    gargs = (op.ptr, op.col, c, t, x)
    want_out, want_lse = r1.rank1_gat_generic_plain(*gargs, 0.2, 300)
    bargs = (*gargs, gout, want_out, want_lse, 0.2, 300)
    att, dpre, dc = r1.r1_bwd(*bargs)
    watt, wdpre, wdc = r1.rank1_gat_generic_bwd_plain(*bargs)
    torch.testing.assert_close(att, watt, rtol=1e-5, atol=1e-6)
    sums_close(dpre, wdpre)
    sums_close(dc, wdc)


@pytest.mark.cuda
@pytest.mark.parametrize("group", r1.GROUPS, ids=lambda g: f"group{g}")
@pytest.mark.parametrize("run", EDGE_RUNS, ids=lambda r: f"run{r}")
@pytest.mark.parametrize("d", [0, 1, 64, 129])
def test_r1_bwd_runs_kernel_matches_plain(d, run, group):
    """r1_bwd_f32 on a graph with rows longer than many runs and empty rows
    (first, middle, last), with a col padded past ptr[n_rows] (pad slots):
    att, dpre and dc against the plain generic backward over NaN-primed
    blocks, twice bit for bit, pads 0, empty rows' dc 0; the same with c
    and t x30; rows whose lse is NEG (no live edge) give att, dpre and dc 0
    and no NaN; and against the walk's mirror."""
    g = long_row_graph(300, 120, long_rows=(1, 298), length=600, seed=d + 8)
    op = r1.Rank1GatOperator(g)
    e, empty, dead = g.num_edges, [0, 150, 299], [1, 7]
    padded = torch.cat([op.col, torch.zeros(40, dtype=op.col.dtype,
                                            device="cuda")])
    gen = torch.Generator(device="cuda").manual_seed(d + 11)
    gout = torch.rand(300, d, generator=gen, device="cuda") - 0.5
    for scale in (1.0, 30.0):
        c, _, x = rank1_inputs(g, 300, 120, d, d + 12, scale)
        t = (torch.rand(120, generator=gen, device="cuda") - 0.5) * scale
        out, lse = r1.rank1_gat_generic_plain(op.ptr, op.col, c, t, x, 0.2,
                                              300)
        lse[dead] = r1.NEG          # rows with edges and no live softmax
        rest = (c, t, x, gout, out, lse, 0.2, 300)
        prime_nan((2, e + 40), (300,), (3 * (e + 40),))
        before = r1.r1_bwd_launches
        att, dpre, dc = twice_same(lambda: r1.r1_bwd(
            op.ptr, op.col, *rest, run=run, group=group))
        assert r1.r1_bwd_launches == before + 2
        want_att, want_dpre, want_dc = r1.rank1_gat_generic_bwd_plain(
            op.ptr, op.col, *rest)
        torch.testing.assert_close(att, want_att, rtol=1e-5, atol=1e-6)
        sums_close(dpre, want_dpre)
        sums_close(dc, want_dc)
        assert not dc[empty].any() and not dc[dead].any()
        for r in dead:
            assert not att[op.ptr[r]:op.ptr[r + 1]].any()
            assert not dpre[op.ptr[r]:op.ptr[r + 1]].any()
        prime_nan((2, e + 40), (300,), (3 * (e + 40),))
        att_p, dpre_p, dc_p = r1.r1_bwd(op.ptr, padded, *rest, run=run,
                                        group=group)
        assert torch.equal(att_p[:e], att) and torch.equal(dpre_p[:e], dpre)
        assert not att_p[e:].any() and not dpre_p[e:].any()
        assert torch.equal(dc_p, dc)
    cpu = [v.cpu() for v in (op.ptr, padded, *rest[:6])]
    m_att, m_dpre, m_dc, writes, dc_writes = \
        fg.rank1_gat_generic_bwd_runs_plain(
            *cpu, 0.2, 300, run or r1.R1_BWD_RUN, group)
    assert bool((writes == 1).all()) and bool((dc_writes == 1).all())
    torch.testing.assert_close(att_p.cpu(), m_att, rtol=1e-5, atol=1e-6)
    sums_close(dpre_p.cpu(), m_dpre)
    sums_close(dc_p.cpu(), m_dc)


@pytest.mark.cuda
def test_r1_bwd_runs_kernel_without_edges():
    """A graph with no edges (and pad slots): dc, att and dpre all 0, for
    every run length."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ptr = torch.zeros(7, dtype=torch.int32, device="cuda")
    col = torch.zeros(50, dtype=torch.int32, device="cuda")
    c, t = torch.randn(6, device="cuda"), torch.randn(4, device="cuda")
    x, gout = torch.randn(4, 8, device="cuda"), torch.randn(6, 8,
                                                             device="cuda")
    out = torch.zeros(6, 8, device="cuda")
    lse = torch.full((6,), r1.NEG, device="cuda")
    for run in (None, 1, 32, 256):
        prime_nan((2, 50), (6,), (150,))
        att, dpre, dc = r1.r1_bwd(ptr, col, c, t, x, gout, out, lse, 0.2, 6,
                                  run=run)
        assert not att.any() and not dpre.any() and not dc.any()


@pytest.mark.cuda
@pytest.mark.parametrize("group", r1.GROUPS, ids=lambda g: f"group{g}")
@pytest.mark.parametrize("run", EDGE_RUNS, ids=lambda r: f"run{r}")
@pytest.mark.parametrize("d", [1, 2, 16, 64, 129])
def test_sddmm_runs_kernel_matches_plain(d, run, group):
    """csr_sddmm_f32 in both orientations (sddmm(g, x), sddmm(x, g)) on a
    graph with rows longer than many runs and empty rows: against the plain
    version over NaN-primed blocks, twice bit for bit, pads 0; operands
    offset by one float (no float4 loads) give the same values; and
    against the walk's mirror."""
    g = long_row_graph(300, 300, long_rows=(1, 298), length=600, seed=d + 13)
    op = cuda_spmm.SpmmOperator(g, device="cuda")
    e, n_out = g.num_edges, g.num_padded_edges + 40
    gen = torch.Generator(device="cuda").manual_seed(d)
    x = torch.rand(300, d, generator=gen, device="cuda") - 0.5
    gout = torch.rand(300, d, generator=gen, device="cuda") - 0.5
    for rows, cols in ((gout, x), (x, gout)):
        prime_nan((n_out,))
        before = cuda_sddmm.launches
        got = twice_same(lambda: cuda_sddmm.csr_sddmm(
            op.ptr, op.col, rows, cols, n_out, run=run, group=group))
        assert cuda_sddmm.launches == before + 2
        want = cuda_sddmm.csr_sddmm_plain(op.ptr, op.col, rows, cols, n_out)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        assert not got[e:].any()
        # rows one float off their 16-byte alignment
        shifted = [torch.empty(v.numel() + 1, device="cuda")[1:]
                   .view_as(v).copy_(v) for v in (rows, cols)]
        got_s = cuda_sddmm.csr_sddmm(op.ptr, op.col, *shifted, n_out,
                                     run=run, group=group)
        torch.testing.assert_close(got_s, want, rtol=1e-5, atol=1e-6)
    cpu = [v.cpu() for v in (op.ptr, op.col, x, gout)]
    mirror, writes = cuda_sddmm.csr_sddmm_runs_plain(
        *cpu, n_out, run or cuda_sddmm.RUN, group)
    assert bool((writes == 1).all())
    torch.testing.assert_close(got.cpu(), mirror, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("run", [None, 1, *sm.RUN_SLOTS],
                         ids=lambda r: f"run{r}")
@pytest.mark.parametrize("masked", [False, True])
def test_softmax_runs_kernels_match_plain_and_mirrors(masked, run):
    """seg_softmax_fwd_f32 and seg_softmax_bwd_f32 at each run length, on
    a graph with rows longer than many runs, runs that hold more than 31
    rows, empty rows and pad slots (NaN in the inputs): against the plain
    versions and the walk's mirrors (at 16 slots a run and more) over
    NaN-primed blocks, twice bit for bit, pads 0; with a mask, a long row
    fully masked gives zeros; one workspace for all calls."""
    g = long_row_graph(300, 300, long_rows=(1, 298), length=600, seed=21)
    ptr, e = g.row_ptr, g.num_edges
    n_out = g.num_padded_edges + 40
    gen = torch.Generator(device="cuda").manual_seed(run or 0)
    logits = torch.randn(n_out, generator=gen, device="cuda") * 3
    gout = torch.randn(n_out, generator=gen, device="cuda")
    logits[e:] = float("nan")
    gout[e:] = float("nan")
    mask = None
    if masked:
        mask = torch.rand(n_out, generator=gen, device="cuda") > 0.3
        mask[int(ptr[298]):int(ptr[299])] = False
    ws = torch.full((sm.ws_floats(n_out, run or sm.RUN),), float("nan"),
                    device="cuda")
    prime_nan((n_out,), (300,), (sm.ws_floats(n_out, 1),))
    before = (sm.fwd_launches, sm.bwd_launches)
    att, lse = twice_same(lambda: sm.seg_softmax_fwd(ptr, logits, mask, e,
                                                     run, ws))
    want_att, want_lse = sm.seg_softmax_fwd_plain(ptr, logits, mask, e)
    torch.testing.assert_close(att, want_att, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-6)
    prime_nan((n_out,), (sm.ws_floats(n_out, 1),))
    dl = twice_same(lambda: sm.seg_softmax_bwd(ptr, want_att, gout, e, run,
                                               ws))
    assert (sm.fwd_launches, sm.bwd_launches) == (before[0] + 2,
                                                  before[1] + 2)
    want_dl = sm.seg_softmax_bwd_plain(ptr, want_att, gout, e)
    sums_close(dl, want_dl)
    assert not att[e:].any() and not dl[e:].any()
    if masked:
        assert not att[~mask].any()
        assert not att[int(ptr[298]):int(ptr[299])].any()
    if run == 1:
        return      # the mirrors merge a 600-edge row's 600 pieces 600 times
    cpu = [v.cpu() for v in (ptr, logits, gout, want_att)]
    m_cpu = None if mask is None else mask.cpu()
    m_att, m_lse, att_w, lse_w = sm.seg_softmax_fwd_runs_plain(
        cpu[0], cpu[1], m_cpu, e, run or sm.RUN)
    m_dl, dl_w = sm.seg_softmax_bwd_runs_plain(cpu[0], cpu[3], cpu[2], e,
                                               run or sm.RUN)
    assert bool((att_w == 1).all()) and bool((lse_w == 1).all())
    assert bool((dl_w == 1).all())
    torch.testing.assert_close(att.cpu(), m_att, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lse.cpu(), m_lse, rtol=1e-5, atol=1e-6)
    sums_close(dl.cpu(), m_dl)


@pytest.mark.cuda
def test_softmax_runs_kernels_through_the_c_entries():
    """Each C entry launched into NaN-filled outputs and workspace writes
    every element of its outputs (pads 0, every lse row) with the
    wrapper's bits; a graph with no edges gives zeros and lse = NEG +
    log(1e-30) on every row; a bad run length or workspace is refused."""
    g = long_row_graph(300, 300, long_rows=(5,), length=900, seed=3)
    ptr, e, n_out = g.row_ptr, g.num_edges, g.num_padded_edges + 7
    gen = torch.Generator(device="cuda").manual_seed(32)
    logits = torch.randn(n_out, generator=gen, device="cuda")
    gout = torch.randn(n_out, generator=gen, device="cuda")
    lib = sm._kernel_lib()
    stream = torch.cuda.current_stream().cuda_stream
    run = 64
    for mask in (None, torch.rand(n_out, generator=gen, device="cuda") > 0.5):
        want = sm.seg_softmax_fwd(ptr, logits, mask, e, run)
        att, lse, ws = (torch.full((k,), float("nan"), device="cuda")
                        for k in (n_out, 300, sm.ws_floats(n_out, run)))
        rc = lib.seg_softmax_fwd_f32(
            ptr.data_ptr(), logits.data_ptr(),
            None if mask is None else mask.data_ptr(), att.data_ptr(), None,
            lse.data_ptr(), ws.data_ptr(), None, 0.0, 1.0, 300, e, n_out,
            run, stream)
        torch.cuda.synchronize()
        assert rc == 0
        assert torch.equal(att, want[0]) and torch.equal(lse, want[1])
    want_dl = sm.seg_softmax_bwd(ptr, want[0], gout, e, run)
    dl, ws = (torch.full((k,), float("nan"), device="cuda")
              for k in (n_out, sm.ws_floats(n_out, run)))
    rc = lib.seg_softmax_bwd_f32(ptr.data_ptr(), want[0].data_ptr(),
                                 gout.data_ptr(), dl.data_ptr(),
                                 ws.data_ptr(), None, 0.0, 1.0, 300, e,
                                 n_out, run, stream)
    torch.cuda.synchronize()
    assert rc == 0 and torch.equal(dl, want_dl)
    # no edges at all, with and without pads
    floor = torch.tensor(sm.NEG) + torch.log(torch.tensor(1e-30))
    for pads in (0, 50):
        zero_ptr = torch.zeros(7, dtype=torch.int32, device="cuda")
        lg = torch.randn(pads, device="cuda")
        prime_nan((pads,), (6,), (sm.ws_floats(pads, 1),))
        att0, lse0 = sm.seg_softmax_fwd(zero_ptr, lg, None, 0, run)
        dl0 = sm.seg_softmax_bwd(zero_ptr, att0, lg, 0, run)
        torch.cuda.synchronize()
        assert not att0.any() and not dl0.any()
        assert bool((lse0.cpu() == floor).all())
    for bad_run in (0, 513):
        rc = lib.seg_softmax_bwd_f32(ptr.data_ptr(), want[0].data_ptr(),
                                     gout.data_ptr(), dl.data_ptr(),
                                     ws.data_ptr(), None, 0.0, 1.0, 300, e,
                                     n_out, bad_run, stream)
        assert rc != 0
    with pytest.raises(ValueError):
        sm.seg_softmax_bwd(ptr, want[0], gout, e, run, ws[:-1])


@pytest.mark.cuda
@pytest.mark.parametrize("run", [None, 1, *sm.RUN_SLOTS],
                         ids=lambda r: f"run{r}")
@pytest.mark.parametrize("masked", [False, True])
def test_softmax_drop_kernels_fold_the_keep_mask_bit_for_bit(masked, run):
    """seg_softmax_fwd_f32 and seg_softmax_bwd_f32 with a seed against the
    composition they fold, bit for bit: att as without dropout, att_k =
    att * keep_scale_plain, dl the VJP of g_k * keep_scale_plain; twice bit
    for bit; through the C entries into NaN-filled outputs and workspace
    (every slot written, the pads 0); a seed without att_k is refused."""
    g = long_row_graph(300, 300, long_rows=(1, 298), length=600, seed=23)
    ptr, e = g.row_ptr, g.num_edges
    n_out = g.num_padded_edges + 40
    gen = torch.Generator(device="cuda").manual_seed(run or 0)
    logits = torch.randn(n_out, generator=gen, device="cuda") * 3
    g_k = torch.randn(n_out, generator=gen, device="cuda")
    mask = (torch.rand(n_out, generator=gen, device="cuda") > 0.3
            if masked else None)
    seed = torch.tensor([-98765], dtype=torch.int32, device="cuda")
    keep = r1.keep_scale_plain(torch.arange(n_out, device="cuda"), seed, 0.5)
    ws = torch.full((sm.ws_floats(n_out, run or sm.RUN),), float("nan"),
                    device="cuda")
    before = (sm.fwd_drop_launches, sm.bwd_drop_launches)
    prime_nan((n_out,), (n_out,), (300,))
    att, att_k, lse = twice_same(lambda: sm.seg_softmax_fwd_drop(
        ptr, logits, mask, e, seed, 0.5, run, ws))
    att0, lse0 = sm.seg_softmax_fwd(ptr, logits, mask, e, run, ws)
    dl = twice_same(lambda: sm.seg_softmax_bwd_drop(ptr, att, g_k, e, seed,
                                                    0.5, run, ws))
    dl0 = sm.seg_softmax_bwd(ptr, att, g_k * keep, e, run, ws)
    torch.cuda.synchronize()
    assert (sm.fwd_drop_launches, sm.bwd_drop_launches) == (before[0] + 2,
                                                            before[1] + 2)
    assert torch.equal(att, att0) and torch.equal(lse, lse0)
    assert torch.equal(att_k, att * keep) and torch.equal(dl, dl0)
    assert not att_k[e:].any() and not dl[e:].any()
    lib = sm._kernel_lib()
    stream = torch.cuda.current_stream().cuda_stream
    rn = run or sm.RUN
    outs = [torch.full((k,), float("nan"), device="cuda")
            for k in (n_out, n_out, 300, n_out)]
    ws.fill_(float("nan"))
    rc = lib.seg_softmax_fwd_f32(
        ptr.data_ptr(), logits.data_ptr(),
        None if mask is None else mask.data_ptr(), outs[0].data_ptr(),
        outs[1].data_ptr(), outs[2].data_ptr(), ws.data_ptr(),
        seed.data_ptr(), 0.5, 2.0, 300, e, n_out, rn, stream)
    rc_b = lib.seg_softmax_bwd_f32(
        ptr.data_ptr(), att.data_ptr(), g_k.data_ptr(), outs[3].data_ptr(),
        ws.data_ptr(), seed.data_ptr(), 0.5, 2.0, 300, e, n_out, rn, stream)
    torch.cuda.synchronize()
    assert rc == 0 and rc_b == 0
    for got, want in zip(outs, (att, att_k, lse, dl)):
        assert torch.equal(got, want)
    assert lib.seg_softmax_fwd_f32(
        ptr.data_ptr(), logits.data_ptr(), None, outs[0].data_ptr(), None,
        outs[2].data_ptr(), ws.data_ptr(), seed.data_ptr(), 0.5, 2.0, 300,
        e, n_out, rn, stream) != 0


@pytest.mark.cuda
def test_materialised_layer_dropout_launches_no_keep_kernel():
    """The materialised layer in training: its attention dropout rides the
    softmax launches (one seg_softmax_fwd_f32 and one seg_softmax_bwd_f32
    with the seed, nothing else for the mask: the keep kernel and its entry
    are gone), its att_k is 0 on a real edge exactly where
    keep_scale_plain is 0, and its output and gradients equal the torch
    path's from the same generator state."""
    from msha_gnn_torch.models import SparseGATLayer

    g = card_graph(12, 200, 200, 0.05, empty_rows=(3,))
    assert not hasattr(r1, "keep_scale")
    assert not hasattr(r1._kernel_lib(), "r1l_keep_scale_f32")
    layer = SparseGATLayer(8, 16, dropout=0.5,
                           generator=torch.Generator().manual_seed(3))
    layer = layer.to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn(200, 8, generator=gen, device="cuda")
    gout = torch.randn(200, 16, generator=gen, device="cuda")
    seen = []
    real = sm.edge_softmax_drop

    def recording(graph, logits, seed, rate):
        att_k = real(graph, logits, seed, rate)
        seen.append((att_k.detach().clone(), seed.clone(), rate))
        return att_k

    got = {}
    for impl in ("materialised", "torch"):
        layer.zero_grad()
        xx = x.clone().requires_grad_()
        before = (sm.fwd_launches, sm.bwd_launches, sm.fwd_drop_launches,
                  sm.bwd_drop_launches)
        sm.edge_softmax_drop = recording
        try:
            out = layer(g, xx, train=True, impl=impl,
                        generator=torch.Generator(device="cuda")
                        .manual_seed(5))
            out.backward(gout)
        finally:
            sm.edge_softmax_drop = real
        torch.cuda.synchronize()
        after = (sm.fwd_launches, sm.bwd_launches, sm.fwd_drop_launches,
                 sm.bwd_drop_launches)
        want = [1, 1, 1, 1] if impl == "materialised" else [0, 0, 0, 0]
        assert [b - a for a, b in zip(before, after)] == want
        got[impl] = (out.detach(), xx.grad, layer.W.grad.clone(),
                     layer.a.grad.clone())
    att_k, seed, rate = seen[0]
    e = g.num_edges
    keep = r1.keep_scale_plain(torch.arange(e, device="cuda"), seed, rate)
    assert torch.equal(att_k[:e] == 0, keep == 0)
    assert not att_k[e:].any()
    torch.testing.assert_close(got["materialised"][0], got["torch"][0],
                               rtol=1e-5, atol=1e-6)
    for u, v in zip(got["materialised"][1:], got["torch"][1:]):
        sums_close(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("group", r1.GROUPS, ids=lambda g: f"group{g}")
@pytest.mark.parametrize("run", EDGE_RUNS, ids=lambda r: f"run{r}")
@pytest.mark.parametrize("d", [0, 1, 64, 129, 300])
def test_spmm_dw_runs_kernel_matches_plain(d, run, group):
    """csr_spmm_dw_f32 at each run length and group of lanes, in both
    directions, on a graph with rows longer than many runs and empty rows:
    against the plain version over NaN-primed blocks, twice bit for bit,
    pads 0 (n_dw past the graph's own pads); operands offset by one float
    (no float4 loads) give the same values; and against the walk's
    mirror."""
    g = long_row_graph(300, 200, long_rows=(1, 298), length=600, seed=d + 7)
    op = cuda_spmm.SpmmOperator(g, device="cuda")
    e, n_dw = g.num_edges, g.num_padded_edges + 40
    gen = torch.Generator(device="cuda").manual_seed(d + 1)
    w = torch.rand(n_dw, generator=gen, device="cuda") + 0.5
    for transpose in (False, True):
        n_in, n_out = (300, 200) if transpose else (200, 300)
        x = torch.rand(n_in, d, generator=gen, device="cuda") - 0.5
        gg = torch.rand(n_out, d, generator=gen, device="cuda") - 0.5
        walk = ((op.ptr, op.col, None, n_in) if transpose
                else (op.t_ptr, op.t_col, op.t_edge, n_in))
        ptr, col, eid, n_rows = walk
        prime_nan((n_dw,), (n_rows, max(d, 1)),
                  (cuda_spmm.sums_ws_floats(n_dw, 1, d),))
        dx, dw = twice_same(lambda: cuda_spmm.csr_spmm_dw(
            ptr, col, eid, w, gg, x, n_rows, n_dw, run=run, group=group))
        want_dx, want_dw = cuda_spmm.csr_spmm_dw_plain(
            ptr, col, eid, w, gg, x, n_rows, n_dw)
        sums_close(dx, want_dx)
        torch.testing.assert_close(dw, want_dw, rtol=1e-5,
                                   atol=1e-6 * max(1, d / 64))
        assert not dw[e:].any()
        shifted = [torch.empty(v.numel() + 1, device="cuda")[1:]
                   .view_as(v).copy_(v) for v in (gg, x)]
        dx_s, dw_s = cuda_spmm.csr_spmm_dw(ptr, col, eid, w, *shifted,
                                           n_rows, n_dw, run=run,
                                           group=group)
        sums_close(dx_s, want_dx)
        torch.testing.assert_close(dw_s, want_dw, rtol=1e-5,
                                   atol=1e-6 * max(1, d / 64))
        if run == 1 or d > 64:
            continue    # the mirror's Python loop over 1-slot runs is slow
        cpu = [None if v is None else v.cpu()
               for v in (ptr, col, eid, w, gg, x)]
        m_dx, m_dw, dx_w, dw_w = cuda_spmm.csr_spmm_dw_runs_plain(
            *cpu, n_rows, n_dw, run or cuda_spmm.DW_RUN,
            group or r1.group_for(d))
        assert bool((dx_w == 1).all()) and bool((dw_w == 1).all())
        sums_close(dx.cpu(), m_dx)
        torch.testing.assert_close(dw.cpu(), m_dw, rtol=1e-5,
                                   atol=1e-6 * max(1, d / 64))


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["gcn", "msha", "ablation3"])
def test_trainer_epoch_on_the_card_matches_the_cpu(model):
    """One epoch of the flow trainer at dropout 0 on the card and on the
    CPU from the same initial weights and batches: the epoch's training
    and eval losses at rtol 1e-4, atol 1e-5, the parameters at atol 1e-4
    (Adam turns last-bit differences of small gradients into update
    differences), the norms' running statistics (means and variances of
    sums over all rows, up to the hundreds) at rtol 1e-4.  The rank metrics are not compared here: scores a few
    ulps apart may swap near-tied ranks (the metrics on the card are held
    to the CPU's on the same scores below).  A GCN step launches
    csr_spmm_f32 2 + 2 times, an evaluation 1 + 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from msha_gnn_torch.cli import _build_task
    from msha_gnn_torch.data import synthetic_flow, train_test_split_records
    from msha_gnn_torch.ops.cuda.spmm import operator_for
    from msha_gnn_torch.training import Trainer, TrainState
    from msha_gnn_torch.utils import TrainConfig

    fg = synthetic_flow(300, 8, 20, 6, 2000, seed=2)
    cfg = TrainConfig(model=model, in_features=16, out_features=8,
                      dropout=0.0, batch_size=64, seed=1)
    train_ids, test_ids = train_test_split_records(fg.num_records, 0.9, 1)
    steps = -(-len(train_ids) // cfg.batch_size)
    runs = []
    for dev in ("cuda", "cpu"):
        task, net = _build_task(cfg, fg, dev)
        trainer = Trainer(task=task, src=fg.edge_src.numpy(),
                          labels=fg.edge_dst.numpy(),
                          batch_size=cfg.batch_size, seed=cfg.seed)
        before = cuda_spmm.launches
        if dev == "cuda" and model == "gcn":
            op = operator_for(task.graph)
            t_before = op.launches_transposed
        state, (record,) = trainer.fit(TrainState.create(net, task.optimizer),
                                       train_ids, test_ids, 1)
        if dev == "cuda" and model == "gcn":
            assert cuda_spmm.launches - before == 4 * steps + 2
            assert op.launches_transposed - t_before == 2 * steps + 1
        elif dev == "cuda":
            assert cuda_spmm.launches == before
        runs.append((record, {k: v.cpu() for k, v in
                              net.state_dict().items()}))
    (card, card_sd), (cpu, cpu_sd) = runs
    assert list(card) == list(cpu)
    for k in ("train_loss", "loss"):
        np.testing.assert_allclose(card[k], cpu[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    params = {k for k, _ in net.named_parameters()}
    for k, v in cpu_sd.items():
        if k in params:
            torch.testing.assert_close(card_sd[k], v, rtol=0, atol=1e-4)
        else:
            torch.testing.assert_close(card_sd[k], v, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_classification_report_on_the_card_matches_the_cpu():
    """The metric block on the card and on the CPU from the same scores,
    many of them tied, with one class absent: the rank sums in float64 and
    the count ratios agree within 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from msha_gnn_torch.training import classification_report

    rng = np.random.default_rng(0)
    scores = torch.from_numpy(
        np.round(rng.normal(size=(5000, 32)), 1).astype(np.float32))
    labels = torch.from_numpy(rng.choice(31, 5000))  # class 31 absent
    cpu = classification_report(scores, labels)
    card = classification_report(scores.cuda(), labels.cuda())
    assert list(card) == list(cpu)
    for k, v in cpu.items():
        assert card[k].is_cuda
        np.testing.assert_allclose(float(card[k]), float(v), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# the bfloat16 payload: csr_spmm_bf16, csr_spmm_dw_bf16, r1l_fwd_bf16,
# r1l_bwd_bf16, against their plain versions on the same bfloat16 rows (the
# plain versions widen the rows and compute in float32, as the kernels do),
# so at the float32 kernels' tolerances; widths that are not multiples of 8
# take the kernels' narrower loads
# ---------------------------------------------------------------------------

BF16_WIDTHS = [1, 3, 12, 64, 129]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("d", BF16_WIDTHS)
def test_spmm_bf16_kernel_matches_plain(d, shape):
    n_src, n_dst = SHAPES[shape]
    g = card_graph(d + 40, n_src, n_dst, 0.05, empty_rows=(0, n_src - 1))
    op = cuda_spmm.SpmmOperator(g, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(d)
    for transpose in (False, True):
        ptr, col, w, n_rows, n_in = (
            (op.t_ptr, op.t_col, op.t_w, n_dst, n_src) if transpose
            else (op.ptr, op.col, op.w, n_src, n_dst))
        x = (torch.rand(n_in, d, generator=gen, device="cuda")
             - 0.5).to(torch.bfloat16)
        for weights in (w, None):
            before = (cuda_spmm.bf16_launches, cuda_spmm.launches)
            got = twice_same(lambda: cuda_spmm.csr_spmm(ptr, col, weights,
                                                        x, n_rows))
            assert (cuda_spmm.bf16_launches, cuda_spmm.launches) == (
                before[0] + 2, before[1])
            assert got.dtype == torch.float32
            sums_close(got, cuda_spmm.csr_spmm_plain(ptr, col, weights, x,
                                                     n_rows))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("d", [3, 12, 64, 129, 300])
def test_spmm_dw_bf16_kernel_matches_plain(d, shape):
    n_src, n_dst = SHAPES[shape]
    g = card_graph(d + 7, n_src, n_dst, 0.05, empty_rows=(0, 150, n_src - 1))
    op = cuda_spmm.SpmmOperator(g, device="cuda")
    e, e_pad = g.num_edges, g.num_padded_edges
    gen = torch.Generator(device="cuda").manual_seed(d)
    w = g.weight * (0.5 + torch.rand(e_pad, generator=gen, device="cuda"))
    bf16 = torch.bfloat16
    for transpose in (False, True):
        n_in, n_out = (n_src, n_dst) if transpose else (n_dst, n_src)
        x = (torch.rand(n_in, d, generator=gen, device="cuda") - 0.5).to(bf16)
        gg = (torch.rand(n_out, d, generator=gen, device="cuda")
              - 0.5).to(bf16)
        if transpose:
            args = (op.ptr, op.col, None, w, gg, x, n_src, e_pad)
        else:
            args = (op.t_ptr, op.t_col, op.t_edge, w, gg, x, n_dst, e_pad)
        prime_nan((e_pad,), (n_in, d))
        before = (cuda_spmm.dw_bf16_launches, cuda_spmm.dw_launches)
        dx, dw = twice_same(lambda: cuda_spmm.csr_spmm_dw(*args))
        assert (cuda_spmm.dw_bf16_launches, cuda_spmm.dw_launches) == (
            before[0] + 2, before[1])
        want_dx, want_dw = cuda_spmm.csr_spmm_dw_plain(*args)
        sums_close(dx, want_dx)
        torch.testing.assert_close(dw, want_dw, rtol=1e-5,
                                   atol=1e-6 * max(1, d / 64))
        assert not dw[e:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("d", BF16_WIDTHS)
def test_rank1_bf16_kernels_match_plain(d, rate):
    g = card_graph(d + 3, 300, 120, 0.05, empty_rows=(0, 151, 299))
    op = r1.Rank1GatOperator(g, dst_linear=True, dropout_rate=rate)
    c, a, x = rank1_inputs(g, 300, 120, d, d + 11)
    xb = x.to(torch.bfloat16)
    gout = torch.rand(300, d, device="cuda") - 0.5
    seed = torch.tensor([-77], dtype=torch.int32, device="cuda")
    args = (op.ptr, op.col, c, a, xb, seed, rate, 0.2, 300)
    before = (r1.fwd_bf16_launches, r1.bwd_bf16_launches, r1.fwd_launches)
    out, lse = twice_same(lambda: r1.r1l_fwd(*args))
    want_out, want_lse = r1.rank1_gat_plain(*args)
    torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-6)
    bwd = (op.ptr, op.col, c, a, xb, gout, want_out, want_lse, seed, rate,
           0.2, 300)
    q, dpre, dc, da = twice_same(lambda: r1.r1l_bwd(*bwd))
    wq, wdpre, wdc, wda = r1.rank1_gat_bwd_plain(*bwd)
    assert (r1.fwd_bf16_launches, r1.bwd_bf16_launches, r1.fwd_launches) \
        == (before[0] + 2, before[1] + 2, before[2])
    torch.testing.assert_close(q, wq, rtol=1e-5, atol=1e-6)
    sums_close(dpre, wdpre)
    sums_close(dc, wdc)
    sums_close(da, wda)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["fused", "materialised", "torch"])
def test_bf16_layer_on_card_matches_the_cpu(impl):
    """SparseGATLayer(precision="bf16") forward and gradients on the card
    (the bfloat16 kernels) against the same layer on the CPU (their plain
    versions) at dropout 0, and the operators' launches."""
    from msha_gnn_torch.models import SparseGATLayer

    g = card_graph(5, 200, 200, 0.05, empty_rows=(0, 199))
    layer = SparseGATLayer(64, 32, dropout=0.0, precision="bf16",
                           generator=torch.Generator().manual_seed(3))
    x = torch.rand(200, 64, generator=torch.Generator().manual_seed(4)) - 0.5
    runs = []
    for dev in ("cuda", "cpu"):
        lay = layer.to(dev)
        xx = x.to(dev).requires_grad_()
        before = (cuda_spmm.bf16_launches, r1.fwd_bf16_launches,
                  r1.bwd_bf16_launches)
        out = lay(g.to(dev), xx, train=True, impl=impl)
        (out ** 2).sum().backward()
        launched = (cuda_spmm.bf16_launches - before[0],
                    r1.fwd_bf16_launches - before[1],
                    r1.bwd_bf16_launches - before[2])
        runs.append((out.detach().cpu(), xx.grad.cpu(),
                     {k: p.grad.cpu() for k, p in lay.named_parameters()},
                     launched))
        lay.zero_grad(set_to_none=True)
    (out_k, dx_k, grads_k, launched), (out_c, dx_c, grads_c, _) = runs
    assert launched == {"fused": (1, 1, 1), "materialised": (2, 0, 0),
                        "torch": (0, 0, 0)}[impl]
    torch.testing.assert_close(out_k, out_c, rtol=1e-5, atol=1e-6)
    sums_close(dx_k, dx_c)
    for k, v in grads_c.items():
        sums_close(grads_k[k], v)


# ---------------------------------------------------------------------------
# the generic rank-1 GAT's bfloat16 payload (r1_fwd_bf16, r1_bwd_bf16), the
# row broadcast (seg_expand_f32) and the out-of-core operators
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("d", BF16_WIDTHS)
def test_generic_bf16_kernels_match_plain(d):
    g = card_graph(d + 9, 300, 120, 0.05, empty_rows=(0, 151, 299))
    op = r1.Rank1GatOperator(g)
    gen = torch.Generator(device="cuda").manual_seed(d)
    c = torch.rand(300, generator=gen, device="cuda") * 4 - 2
    t = (torch.rand(120, generator=gen, device="cuda") * 4 - 2).to(
        torch.bfloat16).float()
    xb = (torch.rand(120, d, generator=gen, device="cuda") - 0.5).to(
        torch.bfloat16)
    gout = torch.rand(300, d, generator=gen, device="cuda") - 0.5
    args = (op.ptr, op.col, c, t, xb, 0.2, 300)
    before = (r1.r1_fwd_bf16_launches, r1.r1_bwd_bf16_launches,
              r1.r1_fwd_launches, r1.r1_bwd_launches)
    prime_nan((300, max(d, 1)), (300,))
    out, lse = twice_same(lambda: r1.r1_fwd(*args))
    want_out, want_lse = r1.rank1_gat_generic_plain(*args)
    torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-6)
    bwd = (op.ptr, op.col, c, t, xb, gout, want_out, want_lse, 0.2, 300)
    att, dpre, dc = twice_same(lambda: r1.r1_bwd(*bwd))
    w_att, w_dpre, w_dc = r1.rank1_gat_generic_bwd_plain(*bwd)
    assert (r1.r1_fwd_bf16_launches, r1.r1_bwd_bf16_launches,
            r1.r1_fwd_launches, r1.r1_bwd_launches) == (
        before[0] + 2, before[1] + 2, before[2], before[3])
    torch.testing.assert_close(att, w_att, rtol=1e-5, atol=1e-6)
    sums_close(dpre, w_dpre)
    sums_close(dc, w_dc)


@pytest.mark.cuda
def test_generic_bf16_operator_on_card_matches_the_cpu():
    """``Rank1GatOperator(precision="bf16")`` under autograd: one
    ``r1_fwd_bf16``, one ``r1_bwd_bf16`` and the two float32 SpMMs of dx
    and dt, against the same operator on the CPU."""
    g = card_graph(4, 200, 90, 0.06, empty_rows=(0, 199))
    gen = torch.Generator().manual_seed(2)
    ins = [torch.randn(200, generator=gen), torch.randn(90, generator=gen),
           torch.randn(90, 16, generator=gen)]
    cot = torch.randn(200, 16, generator=gen)
    runs = []
    for dev in ("cuda", "cpu"):
        op = r1.Rank1GatOperator(g.to(dev), precision="bf16")
        xs = [v.to(dev).clone().requires_grad_() for v in ins]
        before = (r1.r1_fwd_bf16_launches, r1.r1_bwd_bf16_launches,
                  cuda_spmm.launches)
        out = op(*xs)
        out.backward(cot.to(dev))
        runs.append([out.detach().cpu()] + [v.grad.cpu() for v in xs]
                    + [(r1.r1_fwd_bf16_launches - before[0],
                        r1.r1_bwd_bf16_launches - before[1],
                        cuda_spmm.launches - before[2])])
    assert runs[0][-1] == (1, 1, 2) and runs[1][-1] == (0, 0, 0)
    torch.testing.assert_close(runs[0][0], runs[1][0], rtol=1e-5, atol=1e-6)
    for got, want in zip(runs[0][1:4], runs[1][1:4]):
        sums_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("run", [None, 1, 32, 100, 256, 1024])
def test_seg_expand_kernel_matches_plain(run):
    """seg_expand_f32 into NaN-primed memory: every slot written, the edges'
    rows' values bit for bit, the pads 0; rows that are empty at the start,
    in the middle and at the end, and one row across many runs."""
    g = card_graph(7, 300, 500, 0.03, empty_rows=(0, 1, 150, 298, 299))
    dense = g.to_dense()
    dense[40] = 1.0        # a row of 500 edges
    g = tg.BipartiteGraph.from_dense(dense.cpu().numpy(),
                                     pad_to_multiple=16).to("cuda")
    v = torch.randn(300, device="cuda")
    e, e_pad = g.num_edges, g.num_padded_edges
    before = sm.expand_launches
    prime_nan((e_pad,))
    got = twice_same(lambda: sm.seg_expand(g.row_ptr, v, e_pad, e, run))
    assert sm.expand_launches == before + 2
    assert torch.equal(got, sm.seg_expand_plain(g.row_ptr, v, e_pad))
    assert torch.equal(got[:e], v[g.senders[:e].long()])
    assert not got[e:].any()


@pytest.mark.cuda
def test_broadcast_rows_on_card_matches_the_cpu():
    g = card_graph(8, 300, 120, 0.05, empty_rows=(0, 151, 299))
    v = torch.randn(300)
    cot = torch.randint(-8, 9, (g.num_padded_edges,)).float()
    runs = []
    for dev in ("cuda", "cpu"):
        op = sm.SegmentSoftmaxOperator(g.senders, g.row_ptr, 300, device=dev)
        vv = v.to(dev).clone().requires_grad_()
        before = (sm.expand_launches, cuda_spmm.seg_launches)
        out = op.broadcast_rows(vv)
        out.backward(cot.to(dev))
        runs.append((out.detach().cpu(), vv.grad.cpu(),
                     (sm.expand_launches - before[0],
                      cuda_spmm.seg_launches - before[1])))
    assert runs[0][2] == (1, 1) and runs[1][2] == (0, 0)
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])   # integer sums: exact


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_chunked_operators_on_card_match_the_cpu(precision):
    """``ChunkedRank1Gat`` (a hub receiver, a row split across slices) and
    ``ChunkedSpmm.apply`` under autograd on the card, with exact launches a
    slice, against the same operators on the CPU."""
    from msha_gnn_torch.ops.chunked import ChunkedSpmm
    from msha_gnn_torch.ops.chunked_rank1 import ChunkedRank1Gat

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    n, e, k = 400, 6000, 5
    s = np.concatenate([rng.integers(0, n, e - 2000), np.full(2000, 77)])
    r = np.where(rng.random(e) < 0.4, 3, rng.integers(0, n, e))
    gen = torch.Generator().manual_seed(1)
    c, a = torch.randn(n, generator=gen), torch.randn(16, generator=gen) * .3
    x, cot = torch.randn(n, 16, generator=gen), torch.randn(n, 16,
                                                             generator=gen)
    runs = []
    for dev in ("cuda", "cpu"):
        op = ChunkedRank1Gat(s, r, n_src=n, n_dst=n, num_slices=k,
                             precision=precision, device=dev)
        ins = [v.to(dev).clone().requires_grad_() for v in (c, a, x)]
        before = (r1.fwd_launches + r1.fwd_bf16_launches,
                  r1.bwd_launches + r1.bwd_bf16_launches, cuda_spmm.launches)
        out = op(*ins)
        out.backward(cot.to(dev))
        runs.append([out.detach().cpu()] + [v.grad.cpu() for v in ins]
                    + [(r1.fwd_launches + r1.fwd_bf16_launches - before[0],
                        r1.bwd_launches + r1.bwd_bf16_launches - before[1],
                        cuda_spmm.launches - before[2])])
    assert runs[0][-1] == (k, k, 2 * k) and runs[1][-1] == (0, 0, 0)
    torch.testing.assert_close(runs[0][0], runs[1][0], rtol=1e-5, atol=1e-6)
    for got, want in zip(runs[0][1:4], runs[1][1:4]):
        sums_close(got, want)
    if precision == "bf16":
        return
    w = torch.rand(e, generator=gen)
    runs = []
    for dev in ("cuda", "cpu"):
        op = ChunkedSpmm.from_host_coo(s, r, None, n_src=n, n_dst=n,
                                       num_slices=k, device=dev)
        xx = x.to(dev).clone().requires_grad_()
        ww = w.to(dev).clone().requires_grad_()
        before = (cuda_spmm.launches, cuda_sddmm.launches)
        out = op(xx, edge_weight=ww)
        out.backward(cot.to(dev))
        runs.append((out.detach().cpu(), xx.grad.cpu(), ww.grad.cpu(),
                     (cuda_spmm.launches - before[0],
                      cuda_sddmm.launches - before[1])))
    assert runs[0][3] == (2 * k, k) and runs[1][3] == (0, 0)
    for got, want in zip(runs[0][:3], runs[1][:3]):
        sums_close(got, want)


@pytest.mark.cuda
def test_registered_spmm_operator_launches_the_kernel():
    """``torch.ops.msha_gnn_torch.csr_spmm`` on CUDA tensors is the kernel
    (``csr_spmm_f32`` for float32 rows, ``csr_spmm_bf16`` for bfloat16
    ones: one launch counted, the plain version's values at the sums'
    tolerance), on their CPU copies the plain version (no launch)."""
    g = card_graph(5, 400, 40, 0.1)
    op = cuda_spmm.SpmmOperator(g, "cuda")
    x32 = torch.rand((g.n_dst, 16), device="cuda") - 0.5
    for x in (x32, x32.to(torch.bfloat16)):
        before = cuda_spmm.launches, cuda_spmm.bf16_launches
        got = torch.ops.msha_gnn_torch.csr_spmm(op.ptr, op.col, op.w, x,
                                                g.n_src)
        torch.cuda.synchronize()
        bf16 = int(x.dtype == torch.bfloat16)
        after = (before[0] + 1 - bf16, before[1] + bf16)
        assert (cuda_spmm.launches, cuda_spmm.bf16_launches) == after
        assert got.dtype == torch.float32
        want = cuda_spmm.csr_spmm_plain(op.ptr, op.col, op.w, x, g.n_src)
        sums_close(got, want)
        on_cpu = torch.ops.msha_gnn_torch.csr_spmm(
            op.ptr.cpu(), op.col.cpu(), op.w.cpu(), x.cpu(), g.n_src)
        assert (cuda_spmm.launches, cuda_spmm.bf16_launches) == after
        sums_close(on_cpu, want.cpu())


@pytest.mark.cuda
def test_exported_gcn_table_launches_the_kernel_twice():
    """A GCN table exported on the card calls the operator twice; loaded
    back, each call launches ``csr_spmm_f32`` twice and gives the eager
    fill's scores."""
    from msha_gnn_torch.data import synthetic_flow
    from msha_gnn_torch.export import export_scorer, load_scorer
    from msha_gnn_torch.training import gcn_task

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fg = synthetic_flow(600, 8, 20, 6, 4000, seed=2)
    task, model = gcn_task(fg, nfeat=16, device="cuda")
    scorer = load_scorer(export_scorer(task, model))
    before = cuda_spmm.launches
    got = scorer(np.arange(fg.n_src))
    torch.cuda.synchronize()
    assert cuda_spmm.launches == before + 2
    torch.testing.assert_close(got, task.full_scores(model), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["csr_spmm_f32", "csr_sddmm_f32"])
def test_bench_kernels_at_d128_match_plain(kernel):
    """``bench_spmm`` / ``bench_sddmm``'s kernels at d = 128 on a smaller
    power-law graph (``csr_spmm_f32``'s float4 rows: ``x`` 16-byte
    aligned), twice bit for bit, against their plain versions at the sums'
    tolerance (dots and row sums of 128 terms and more)."""
    from msha_gnn_torch.bench import make_powerlaw_graph

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g, x = make_powerlaw_graph(8192, 8192, 200_000, d=128, device="cuda")
    op = cuda_spmm.SpmmOperator(g, "cuda")
    if kernel == "csr_spmm_f32":
        assert x.data_ptr() % 16 == 0
        args = (op.ptr, op.col, op.w, x, g.n_src)
        launch, plain = cuda_spmm.csr_spmm, cuda_spmm.csr_spmm_plain
    else:
        a = torch.randn((g.n_src, 128), device="cuda")
        args = (op.ptr, op.col, a, x, g.num_padded_edges)
        launch, plain = cuda_sddmm.csr_sddmm, cuda_sddmm.csr_sddmm_plain
    got, again = launch(*args), launch(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    sums_close(got, plain(*args))


@pytest.mark.cuda
def test_bench_attention_sparse_path_matches_dense_on_card():
    """The benchmark's sparse attention path (the kernels) against its
    dense path on the card, outputs and both gradients, on a graph without
    empty rows, with its exact launches: the forward 1 ``csr_sddmm_f32``
    (the logits), 1 ``seg_softmax_fwd_f32`` and 2 ``csr_spmm_f32``; the
    forward and backward 3 (the logits, each SpMM's ``dw``), 1, 1
    ``seg_softmax_bwd_f32`` and 6 (the two SpMMs, their ``dx``, the
    logits' two d = 2 adjoints)."""
    import functools

    from msha_gnn_torch import bench

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(4)
    src = np.concatenate([np.arange(500), rng.integers(0, 500, 3500)])
    dense = np.zeros((500, 32), np.float32)
    np.add.at(dense, (src, rng.integers(0, 32, 4000)), 1.0)
    g = tg.BipartiteGraph.from_dense(dense).to("cuda")
    x = bench.attention_inputs(g, 64)
    ops = bench.attention_operators(g)
    kw = dict(a_src=x["a_src"], a_dst=x["a_dst"])
    dense_path = functools.partial(bench.attention_dense_path,
                                   mask=x["mask"], **kw)
    sparse_path = functools.partial(bench.attention_sparse_path, ops=ops,
                                    **kw)
    counts = (cuda_sddmm.launches, sm.fwd_launches, sm.bwd_launches,
              cuda_spmm.launches)
    got = sparse_path(x["h1"], x["h2"])
    torch.cuda.synchronize()
    after = (cuda_sddmm.launches, sm.fwd_launches, sm.bwd_launches,
             cuda_spmm.launches)
    assert [b - a for a, b in zip(counts, after)] == [1, 1, 0, 2]
    grads = bench.attention_grads(sparse_path, x["h1"], x["h2"], x["ct_n"],
                                  x["ct_m"])
    torch.cuda.synchronize()
    final = (cuda_sddmm.launches, sm.fwd_launches, sm.bwd_launches,
             cuda_spmm.launches)
    assert [b - a for a, b in zip(after, final)] == [3, 1, 1, 6]
    want = (*dense_path(x["h1"], x["h2"]),
            *bench.attention_grads(dense_path, x["h1"], x["h2"], x["ct_n"],
                                   x["ct_m"]))
    for w, t in zip(want, (*got, *grads)):
        sums_close(t, w)


@pytest.mark.cuda
def test_sharded_operators_bit_equal_on_the_card():
    """At world size 1 over NCCL the sharded operators run the
    single-device operators' kernels on the same CSR: outputs and
    gradients bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from msha_gnn_torch.parallel import (ShardedCsrSpmm, ShardedRank1Gat,
                                         initialize, make_mesh, shutdown)

    rng = np.random.default_rng(0)
    n, e, d = 300, 4000, 64
    g = tg.BipartiteGraph.from_coo(rng.integers(0, n, e),
                                   rng.integers(0, n, e),
                                   rng.random(e).astype(np.float32),
                                   n_src=n, n_dst=n).to("cuda")
    initialize(device="cuda")
    try:
        mesh = make_mesh()

        def run(fn, *inputs):
            inputs = [t.detach().clone().requires_grad_() for t in inputs]
            out = fn(*inputs)
            out.backward(torch.ones_like(out))
            return [out] + [t.grad for t in inputs]

        x = torch.rand(n, d, device="cuda")
        c = torch.rand(n, device="cuda")
        a = torch.rand(d, device="cuda")
        w = torch.rand(g.num_padded_edges, device="cuda")
        pairs = [
            (run(r1.Rank1GatOperator(g, dst_linear=True), c, a, x),
             run(ShardedRank1Gat(g, mesh), c, a, x)),
            (run(lambda x, w: cuda_spmm.SpmmOperator(g, "cuda")(
                x, edge_weight=w), x, w),
             run(lambda x, w: ShardedCsrSpmm(g, mesh)(x, edge_weight=w),
                 x, w)),
        ]
        for want, got in pairs:
            for i, (u, v) in enumerate(zip(want, got)):
                if i and u.shape == w.shape:  # dw: the real edges
                    u, v = u[:g.num_edges], v[:g.num_edges]
                assert torch.equal(u, v)
    finally:
        shutdown()
