"""The port's fused rank-1 GAT operator against the JAX package's.

The JAX side runs as its own tests run it on the CPU:
``Rank1GatOperator.build(..., interpret=True, dst_linear=True)``, whose
Pallas kernels ``_r1l_fwd_kernel`` and ``_r1l_bwd_kernel`` run in
interpret mode.  The port's operator runs the plain versions of its
kernels on CPU tensors, with the operator's own bookkeeping (autograd,
the dropout seed, the edge-row reduce of ``dx``) under test.

Tolerances are the JAX package's own for this operator
(``tests/test_rank1_dropout.py``): forward rtol 1e-4, atol 1e-5;
gradients rtol 2e-3, atol 1e-3.  The Pallas f32 path sums through a bf16
hi/lo split with about 2^-16 relative error, and the gradients add up
longer chains of such terms.  The keep mask is compared bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msha_gnn_tpu.graph as jg
import msha_gnn_torch.graph as tg
from msha_gnn_tpu.ops import edge_softmax as jax_edge_softmax
from msha_gnn_tpu.ops import sddmm as jax_sddmm
from msha_gnn_tpu.ops.pallas import Rank1GatOperator as JaxRank1
from msha_gnn_tpu.ops.segment import segment_max as jax_segment_max
from msha_gnn_tpu.ops.segment import segment_softmax as jax_segment_softmax
from msha_gnn_torch.ops import edge_softmax, sddmm, segment_max, \
    segment_softmax
from msha_gnn_torch.ops.cuda import rank1_gat as r1
from msha_gnn_torch.ops.cuda import spmm as cuda_spmm
from tests.test_rank1_dropout import host_keep_scale

FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-3


def dense_graph(seed, n_src, n_dst, density, empty_rows=()):
    """A random 0/1..4 weighted adjacency with some rows emptied, as both
    packages' graphs (pad edges to a multiple of 16)."""
    rng = np.random.default_rng(seed)
    dense = ((rng.random((n_src, n_dst)) < density)
             * rng.integers(1, 5, (n_src, n_dst))).astype(np.float32)
    dense[list(empty_rows)] = 0.0
    return (tg.BipartiteGraph.from_dense(dense, pad_to_multiple=16),
            jg.BipartiteGraph.from_dense(dense, pad_to_multiple=16))


CASES = {
    # n_src not a multiple of 128, with empty rows (first, middle, last)
    "300x120_d16": dict(seed=0, n_src=300, n_dst=120, density=0.05, d=16,
                        empty_rows=(0, 151, 299)),
    "150x70_d8": dict(seed=1, n_src=150, n_dst=70, density=0.08, d=8,
                      empty_rows=(7,)),
}


@pytest.mark.parametrize("slots_seed", [0, 1, 12345, -1, -2**31, 2**31 - 1])
@pytest.mark.parametrize("rate", [0.25, 0.5])
def test_keep_scale_plain_is_bit_exact(rate, slots_seed):
    slots = np.arange(1 << 20)
    # the int32 seed's bit pattern, which is what the hash adds
    want = host_keep_scale(slots, slots_seed & 0xFFFFFFFF, rate)
    seed = torch.tensor([slots_seed], dtype=torch.int32)
    got = r1.keep_scale_plain(torch.from_numpy(slots), seed, rate).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        r1.keep_scale_plain(torch.arange(1000), seed, rate).numpy(),
        want[:1000])


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_operator_matches_pallas(case, rate):
    p = CASES[case]
    gt, gj = dense_graph(p["seed"], p["n_src"], p["n_dst"], p["density"],
                         p["empty_rows"])
    rng = np.random.default_rng(p["seed"] + 10)
    d = p["d"]
    c = rng.standard_normal(gt.n_src).astype(np.float32)
    a = (rng.standard_normal(d) * 0.3).astype(np.float32)
    x = rng.standard_normal((gt.n_dst, d)).astype(np.float32)
    ct = rng.standard_normal((gt.n_src, d)).astype(np.float32)
    seed = -123457 if rate else 0

    jop = JaxRank1.build(gj, interpret=True, dst_linear=True,
                         dropout_rate=rate)
    seed_j = jnp.asarray([seed], jnp.int32)

    def jax_fn(c, a, x):
        return jop.drop(c, a, x, seed_j) if rate else jop(c, a, x)

    want, vjp = jax.vjp(jax_fn, jnp.asarray(c), jnp.asarray(a),
                        jnp.asarray(x))
    want_grads = vjp(jnp.asarray(ct))

    op = r1.Rank1GatOperator(gt, dst_linear=True, dropout_rate=rate)
    ins = [torch.from_numpy(v).requires_grad_() for v in (c, a, x)]
    before = (r1.fwd_launches, r1.bwd_launches, cuda_spmm.launches)
    got = (op.drop(*ins, torch.tensor([seed], dtype=torch.int32)) if rate
           else op(*ins))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    got.backward(torch.from_numpy(ct))
    for name, t, w in zip(("dc", "da", "dx"), ins, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (r1.fwd_launches, r1.bwd_launches, cuda_spmm.launches) == before
    # empty rows give zeros and no gradient to c
    rows = list(p["empty_rows"])
    assert not got.detach()[rows].any() and not ins[0].grad[rows].any()


def test_drop_at_rate_zero_equals_call():
    gt, _ = dense_graph(2, 90, 40, 0.1)
    rng = np.random.default_rng(3)
    c, a, x = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in (90, 8, (40, 8)))
    op = r1.Rank1GatOperator(gt, dst_linear=True, dropout_rate=0.0)
    assert torch.equal(op.drop(c, a, x, torch.tensor([99], dtype=torch.int32)),
                       op(c, a, x))


def test_plain_backward_is_the_autograd_of_the_plain_forward():
    """``rank1_gat_bwd_plain``'s ``(q, dpre, dc, da)``, with ``dx``
    assembled from ``q`` and ``dpre`` as the operator does (the
    ``q``-weighted transposed SpMM of ``gout`` plus ``a`` times the column
    sums of ``dpre``), equals torch's autograd through ``rank1_gat_plain``,
    with dropout.  In float64: the autograd path carries the softmax's max
    and sum terms, which cancel only up to rounding."""
    gt, _ = dense_graph(4, 200, 80, 0.06, empty_rows=(5, 199))
    op = cuda_spmm.SpmmOperator(gt, device="cpu")
    rng = np.random.default_rng(5)
    c, a, x = (torch.from_numpy(rng.standard_normal(s)).requires_grad_()
               for s in (200, 16, (80, 16)))
    gout = torch.from_numpy(rng.standard_normal((200, 16)))
    seed, rate, slope = torch.tensor([7], dtype=torch.int32), 0.5, 0.2
    out, lse = r1.rank1_gat_plain(op.ptr, op.col, c, a, x, seed, rate, slope,
                                  200)
    out.backward(gout)
    q, dpre, dc, da = r1.rank1_gat_bwd_plain(op.ptr, op.col, c.detach(),
                                             a.detach(), x.detach(), gout,
                                             out.detach(), lse, seed, rate,
                                             slope, 200)
    assert q.shape == dpre.shape == (gt.num_edges,)
    dx = r1.assemble_dx(op, gout, a.detach(), q, dpre)
    for got, want in ((dc, c.grad), (da, a.grad), (dx, x.grad)):
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)
    assert bool((lse[[5, 199]] == r1.NEG).all())


def test_drop_needs_dst_linear():
    """``drop`` on a generic operator raises: the JAX operator's runs the
    dst_linear form on ``(c, t, x)`` without a word
    (``rank1_gat.py:861-891``).  A dst_linear operator drops; the other
    arguments are checked."""
    gt, _ = dense_graph(6, 40, 20, 0.2)
    seed = torch.tensor([1], dtype=torch.int32)
    op = r1.Rank1GatOperator(gt, dropout_rate=0.5)
    assert not op.dst_linear
    with pytest.raises(ValueError, match="dst_linear"):
        op.drop(torch.zeros(40), torch.zeros(4), torch.zeros(20, 4), seed)
    lin = r1.Rank1GatOperator(gt, dst_linear=True, dropout_rate=0.5)
    assert lin.drop(torch.zeros(40), torch.zeros(4), torch.zeros(20, 4),
                    seed).shape == (40, 4)
    with pytest.raises(ValueError, match="dropout_rate"):
        r1.Rank1GatOperator(gt, dropout_rate=1.0)
    # the generic form takes bf16 rows (tests/test_torch_generic_bf16.py),
    # and has no attention dropout at any precision
    gen16 = r1.Rank1GatOperator(gt, precision="bf16", dropout_rate=0.5)
    with pytest.raises(ValueError, match="dst_linear"):
        gen16.drop(torch.zeros(40), torch.zeros(4), torch.zeros(20, 4), seed)
    with pytest.raises(ValueError, match="t"):
        op(torch.zeros(40), torch.zeros(4), torch.zeros(20, 4))


def test_segment_ops_and_edge_softmax_match_jax():
    """The plain pieces of the oracle: segment max/softmax, the rank-1
    SDDMM logits and the row softmax over edges."""
    gt, gj = dense_graph(8, 60, 25, 0.15, empty_rows=(3,))
    rng = np.random.default_rng(9)
    s_src = rng.standard_normal(60).astype(np.float32)
    s_dst = rng.standard_normal(25).astype(np.float32)
    logits_j = jax_sddmm(gj, jnp.asarray(s_src), jnp.asarray(s_dst))
    logits_t = sddmm(gt, torch.from_numpy(s_src), torch.from_numpy(s_dst))
    e = gt.num_edges
    np.testing.assert_allclose(logits_t.numpy()[:e],
                               np.asarray(logits_j)[:e], rtol=1e-6)
    np.testing.assert_allclose(edge_softmax(gt, logits_t).numpy(),
                               np.asarray(jax_edge_softmax(gj, logits_j)),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        edge_softmax(gt, logits_t, per="dst").numpy(),
        np.asarray(jax_edge_softmax(gj, logits_j, per="dst")),
        rtol=1e-5, atol=1e-7)
    ids = rng.integers(0, 8, 50)  # 8 = the padding id of 8 segments
    data = rng.standard_normal(50).astype(np.float32)
    np.testing.assert_array_equal(
        segment_max(torch.from_numpy(data), torch.from_numpy(ids), 7).numpy(),
        np.asarray(jax_segment_max(jnp.asarray(data), jnp.asarray(ids), 7)))
    np.testing.assert_allclose(
        segment_softmax(torch.from_numpy(data), torch.from_numpy(ids),
                        7).numpy(),
        np.asarray(jax_segment_softmax(jnp.asarray(data), jnp.asarray(ids),
                                       7)), rtol=1e-5, atol=1e-7)
