"""The port's row softmax over edges against the JAX package's.

The JAX side runs ``SegmentSoftmaxOperator`` with ``interpret=True``: its
Pallas kernels ``_stats_kernel``, ``_expand_kernel`` and ``_rowsum_kernel``
in interpret mode.  The port's operator runs the plain versions of
``seg_softmax_fwd_f32`` and ``seg_softmax_bwd_f32`` on CPU tensors, with
its own bookkeeping (the mask, the pad slots, autograd) under test.

The cases cover empty rows, a row count that is not a multiple of 128
(the TPU kernels' row block), the build mask ``senders < n_src`` and an
arbitrary mask that leaves one row fully masked.  Tolerances are the JAX
package's own for this operator (``tests/test_pallas_softmax.py``):
``att`` rtol 1e-5, atol 1e-6 (the TPU kernels keep float32 throughout;
the two sides take exp and the row sums in another order); the VJP rtol
1e-4, atol 1e-5, since it adds a row sum of products.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msha_gnn_tpu.graph as jg
import msha_gnn_torch.graph as tg
from msha_gnn_tpu.ops.pallas import SegmentSoftmaxOperator as JaxSoftmax
from msha_gnn_torch.ops import edge_softmax
from msha_gnn_torch.ops.cuda import softmax as sm

ATT_RTOL, ATT_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def graphs(seed, n_src, n_dst, density, empty_rows=()):
    rng = np.random.default_rng(seed)
    dense = ((rng.random((n_src, n_dst)) < density)
             * rng.integers(1, 5, (n_src, n_dst))).astype(np.float32)
    dense[list(empty_rows)] = 0.0
    return (tg.BipartiteGraph.from_dense(dense, pad_to_multiple=64),
            jg.BipartiteGraph.from_dense(dense, pad_to_multiple=64))


CASES = {
    # 300 rows (not a multiple of 128), empty first, middle and last rows
    "300x120": dict(seed=0, n_src=300, n_dst=120, density=0.05,
                    empty_rows=(0, 151, 299)),
    # one row of 140 edges, more than a TPU chunk of 128
    "130x160": dict(seed=1, n_src=130, n_dst=160, density=0.04,
                    empty_rows=(64,), long_row=5),
}


def case_graph(name):
    p = dict(CASES[name])
    long_row = p.pop("long_row", None)
    gt, gj = graphs(**p)
    if long_row is not None:
        rng = np.random.default_rng(p["seed"])
        dense = gt.to_dense().numpy()
        dense[long_row, rng.permutation(p["n_dst"])[:140]] = 1.0
        gt = tg.BipartiteGraph.from_dense(dense, pad_to_multiple=64)
        gj = jg.BipartiteGraph.from_dense(dense, pad_to_multiple=64)
    return gt, gj


def masks(gt, kind):
    build = gt.edge_mask.numpy()
    if kind == "build":
        return build
    # drop a third of the real edges and every edge of one non-empty row
    rng = np.random.default_rng(11)
    mask = build.copy()
    real = np.flatnonzero(mask)
    mask[rng.permutation(real)[: len(real) // 3]] = False
    ptr = gt.row_ptr.numpy()
    row = int(np.flatnonzero(np.diff(ptr) > 2)[1])
    mask[ptr[row]:ptr[row + 1]] = False
    return mask


@pytest.mark.parametrize("kind", ["build", "arbitrary"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_operator_matches_pallas(case, kind):
    gt, gj = case_graph(case)
    mask = masks(gt, kind)
    rng = np.random.default_rng(len(case) + len(kind))
    e_pad = gt.num_padded_edges
    logits = (rng.standard_normal(e_pad) * 3).astype(np.float32)
    ct = rng.standard_normal(e_pad).astype(np.float32)
    jop = JaxSoftmax(np.asarray(gj.senders), np.asarray(gj.row_ptr), gj.n_src,
                     mask=mask, interpret=True)
    want, vjp = jax.vjp(jop, jnp.asarray(logits))
    (want_dl,) = vjp(jnp.asarray(ct))

    op = sm.SegmentSoftmaxOperator(gt.senders, gt.row_ptr, gt.n_src,
                                   mask=torch.from_numpy(mask), device="cpu")
    lt = torch.from_numpy(logits).requires_grad_()
    before = (sm.fwd_launches, sm.bwd_launches)
    att = op(lt)
    np.testing.assert_allclose(att.detach().numpy(), np.asarray(want),
                               rtol=ATT_RTOL, atol=ATT_ATOL)
    att.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want_dl),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (sm.fwd_launches, sm.bwd_launches) == before
    # masked edges and pads get exactly 0, and so does their gradient
    assert not att.detach()[~torch.from_numpy(mask)].any()
    assert not lt.grad[~torch.from_numpy(mask)].any()
    # every row with an unmasked edge sums to 1
    rows = gt.senders.long()
    sums = torch.zeros(gt.n_src + 1).index_add_(0, rows, att.detach())
    live = torch.zeros(gt.n_src + 1).index_add_(
        0, rows, torch.from_numpy(mask).float())[: gt.n_src] > 0
    torch.testing.assert_close(sums[: gt.n_src][live],
                               torch.ones(int(live.sum())))


def test_fully_masked_and_empty_rows_keep_zero_sum():
    """A fully masked row, like an empty one, gives zeros and ``lse = NEG +
    log(1e-30)``: its masked edges take no part in its statistics."""
    gt, _ = case_graph("300x120")
    mask = masks(gt, "arbitrary")
    ptr = gt.row_ptr.numpy()
    full = [r for r in range(gt.n_src) if ptr[r + 1] > ptr[r]
            and not mask[ptr[r]:ptr[r + 1]].any()]
    empty = [0, 151, 299]
    assert full and all(ptr[r + 1] == ptr[r] for r in empty)
    logits = torch.randn(gt.num_padded_edges,
                         generator=torch.Generator().manual_seed(0))
    att, lse = sm.seg_softmax_fwd_plain(gt.row_ptr, logits,
                                        torch.from_numpy(mask), gt.num_edges)
    floor = torch.tensor(sm.NEG) + torch.log(torch.tensor(1e-30))
    assert bool((lse[full + empty] == floor).all())
    for r in full:
        assert not att[ptr[r]:ptr[r + 1]].any()


def test_edge_softmax_impls_agree_and_build_from_the_graph():
    gt, _ = case_graph("130x160")
    logits = torch.randn(gt.num_padded_edges,
                         generator=torch.Generator().manual_seed(1)) * 2
    want = edge_softmax(gt, logits)
    got = edge_softmax(gt, logits, impl="cuda")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
    op = sm.softmax_operator_for(gt)
    assert op is sm.softmax_operator_for(gt)       # cached per graph
    # the build mask senders < n_src is False only past row_ptr[-1]: the
    # operator leaves it out and gives what the masked operator gives
    assert op.mask is None and op.num_edges == gt.num_edges
    assert not bool(gt.edge_mask[gt.num_edges:].any())
    masked = sm.SegmentSoftmaxOperator(gt.senders, gt.row_ptr, gt.n_src,
                                       mask=gt.edge_mask, device="cpu")
    assert torch.equal(op(logits), masked(logits))
    # the column softmax takes the plain path, as the JAX impl="pallas"
    # takes its XLA path there
    assert torch.equal(edge_softmax(gt, logits, per="dst", impl="cuda"),
                       edge_softmax(gt, logits, per="dst"))
    with pytest.raises(ValueError, match="unknown edge_softmax impl"):
        edge_softmax(gt, logits, impl="pallas")
    with pytest.raises(ValueError, match="logits must be"):
        op(logits[:-1])


def test_plain_backward_is_the_autograd_of_the_plain_forward():
    """``seg_softmax_bwd_plain`` equals torch's autograd through
    ``seg_softmax_fwd_plain``, in float64."""
    gt, _ = case_graph("300x120")
    mask = torch.from_numpy(masks(gt, "arbitrary"))
    gen = torch.Generator().manual_seed(2)
    logits = torch.randn(gt.num_padded_edges, dtype=torch.float64,
                         generator=gen).requires_grad_()
    ct = torch.randn(gt.num_padded_edges, dtype=torch.float64, generator=gen)
    att, _ = sm.seg_softmax_fwd_plain(gt.row_ptr, logits, mask, gt.num_edges)
    att.backward(ct)
    dl = sm.seg_softmax_bwd_plain(gt.row_ptr, att.detach(), ct, gt.num_edges)
    torch.testing.assert_close(dl, logits.grad, rtol=1e-10, atol=1e-12)
