"""The port's generic rank-1 GAT operator (``Rank1GatOperator`` with
``dst_linear=False``, its default) against the JAX package's.

The JAX side runs as its own tests run it on the CPU
(``tests/test_rank1_gat.py``): ``Rank1GatOperator.build(g,
interpret=True)``, whose Pallas kernels ``_r1_fwd_kernel`` and
``_r1_bwd_kernel`` run in interpret mode.  The port's operator runs the
plain versions of its kernels (``r1_fwd_f32``, ``r1_bwd_f32``) on CPU
tensors, with the operator's own bookkeeping under test: autograd, ``dx``
as the att-weighted transposed SpMM of ``gout`` and ``dt`` as the edge-row
reduce of ``dpre``.

Tolerances are the JAX package's own for this operator: forward rtol
1e-4, atol 1e-5; gradients rtol 2e-3, atol 1e-4 (the Pallas f32 path sums
through a bf16 hi/lo split with about 2^-16 relative error, and the
gradients add up longer chains of such terms).  The graphs are
rectangular (300 x 120 and 150 x 70, as the JAX tests', so a mix-up of
``n_src`` and ``n_dst`` shows), with ``n_src`` not a multiple of 128,
empty rows, and pad edges whose sender is ``n_src``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msha_gnn_tpu.ops.pallas import Rank1GatOperator as JaxRank1
from msha_gnn_torch.ops.cuda import rank1_gat as r1
from msha_gnn_torch.ops.cuda import spmm as cuda_spmm
from tests.test_torch_rank1_gat import dense_graph

FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-4


def inputs(seed, n_src, n_dst, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((n_src,), (n_dst,), (n_dst, d), (n_src, d)))


def counts():
    return (r1.r1_fwd_launches, r1.r1_bwd_launches, cuda_spmm.launches)


@pytest.mark.parametrize("d", [8, 64])
def test_forward_matches_pallas(d):
    gt, gj = dense_graph(20 + d, 300, 120, 0.05, empty_rows=(0, 151, 299))
    c, t, x, _ = inputs(d, 300, 120, d)
    want = np.asarray(JaxRank1.build(gj, interpret=True)(
        jnp.asarray(c), jnp.asarray(t), jnp.asarray(x)))
    op = r1.Rank1GatOperator(gt)
    before = counts()
    got = op(*(torch.from_numpy(v) for v in (c, t, x)))
    assert got.shape == (300, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    assert not got[[0, 151, 299]].any()
    # CPU tensors take the plain versions: no kernel launch is counted
    assert counts() == before


def test_gradients_match_pallas_vjp():
    gt, gj = dense_graph(31, 150, 70, 0.08, empty_rows=(7,))
    c, t, x, ct = inputs(3, 150, 70, 16)
    jop = JaxRank1.build(gj, interpret=True)
    _, vjp = jax.vjp(jop, jnp.asarray(c), jnp.asarray(t), jnp.asarray(x))
    want = vjp(jnp.asarray(ct))
    op = r1.Rank1GatOperator(gt)
    ins = [torch.from_numpy(v).requires_grad_() for v in (c, t, x)]
    op(*ins).backward(torch.from_numpy(ct))
    for name, got, w in zip(("dc", "dt", "dx"), ins, want):
        assert got.grad.shape == got.shape
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
    assert not ins[0].grad[7]


@pytest.mark.parametrize("d", [8, 32])
def test_dst_linear_identities(d):
    """At ``t = x @ a`` the generic form computes the dst_linear form's
    output, and its gradients give the dst_linear ones through ``da = x^T
    dt`` and ``dx_lin = dx_gen + dt a^T`` (``tests/test_rank1_gat.py``'s
    dst_linear check, on the port's two forms).  In float64, so the
    identities hold to rounding."""
    gt, _ = dense_graph(40 + d, 200, 90, 0.06, empty_rows=(3, 199))
    rng = np.random.default_rng(d)
    c = torch.from_numpy(rng.standard_normal(200))
    a = torch.from_numpy(rng.standard_normal(d) * 0.3)
    x = torch.from_numpy(rng.standard_normal((90, d)))
    ct = torch.from_numpy(rng.standard_normal((200, d)))
    lin = [v.clone().requires_grad_() for v in (c, a, x)]
    out_lin = r1.Rank1GatOperator(gt, dst_linear=True)(*lin)
    out_lin.backward(ct)
    gen = [v.clone().requires_grad_() for v in (c, x @ a, x)]
    out_gen = r1.Rank1GatOperator(gt)(*gen)
    out_gen.backward(ct)
    close = dict(rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(out_gen, out_lin, **close)
    dc, dt, dx = (v.grad for v in gen)
    torch.testing.assert_close(dc, lin[0].grad, **close)
    torch.testing.assert_close(x.T @ dt, lin[1].grad, **close)
    torch.testing.assert_close(dx + dt[:, None] * a[None, :], lin[2].grad,
                               **close)


def test_pads_and_empty_rows_against_pallas():
    """``n_src = 200`` (not a multiple of 128) with pad edges, whose sender
    ``n_src`` is a real row of the TPU's last block, and empty rows: an
    empty row gets 0 and ``lse == NEG`` and no gradient, and nothing is
    NaN, in the port as in the JAX operator."""
    gt, gj = dense_graph(50, 200, 60, 0.07, empty_rows=(0, 64, 199))
    assert gt.num_padded_edges > gt.num_edges
    c, t, x, ct = inputs(51, 200, 60, 8)
    c, t = c * 5, t * 5  # logits far apart: the online renormalisation
    jop = JaxRank1.build(gj, interpret=True)
    want, vjp = jax.vjp(jop, jnp.asarray(c), jnp.asarray(t), jnp.asarray(x))
    want_grads = vjp(jnp.asarray(ct))
    op = r1.Rank1GatOperator(gt)
    ins = [torch.from_numpy(v).requires_grad_() for v in (c, t, x)]
    got = op(*ins)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    for name, v, w in zip(("dc", "dt", "dx"), ins, want_grads):
        assert torch.isfinite(v.grad).all(), name
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(w),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
    empty = [0, 64, 199]
    _, lse = r1.r1_fwd(op.ptr, op.col, *(v.detach() for v in ins), op.slope,
                       200)
    assert bool((lse[empty] == r1.NEG).all())
    assert not got.detach()[empty].any() and not ins[0].grad[empty].any()


def test_plain_backward_is_the_autograd_of_the_plain_forward():
    """``rank1_gat_generic_bwd_plain`` with the two reduces (``dx`` weighted
    by ``att``, ``dt`` of ``dpre``) equals torch's autograd through
    ``rank1_gat_generic_plain``, in float64."""
    gt, _ = dense_graph(60, 200, 80, 0.06, empty_rows=(5, 199))
    op = cuda_spmm.SpmmOperator(gt, device="cpu")
    rng = np.random.default_rng(61)
    c, t, x = (torch.from_numpy(rng.standard_normal(s)).requires_grad_()
               for s in (200, 80, (80, 16)))
    gout = torch.from_numpy(rng.standard_normal((200, 16)))
    out, lse = r1.rank1_gat_generic_plain(op.ptr, op.col, c, t, x, 0.2, 200)
    out.backward(gout)
    att, dpre, dc = r1.rank1_gat_generic_bwd_plain(
        op.ptr, op.col, c.detach(), t.detach(), x.detach(), gout,
        out.detach(), lse, 0.2, 200)
    assert att.shape == dpre.shape == (gt.num_edges,)
    for got, want in ((dc, c.grad),
                      (op.reduce_edges(dpre[:, None])[:, 0], t.grad),
                      (op.apply(gout, att, transpose=True), x.grad)):
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)
