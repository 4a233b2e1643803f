"""``SegmentSoftmaxOperator.broadcast_rows``, the differentiable row
broadcast ``v[row] -> v[senders[e]]`` of the out-of-core training step,
against the JAX operator's (``softmax.py:338-364``: ``_expand`` forward,
``_rowsum`` adjoint, in interpret mode), on the CPU.

Both directions are held exactly: the forward copies float32 values, and
the adjoint's cotangent is integer-valued (|g| <= 8), so its float32 row
sums are exact in any order.  The pad slots broadcast 0 and add nothing,
whatever their cotangent.  The port's CPU operator runs the plain
versions of ``seg_expand_f32`` and ``seg_reduce_f32`` and launches
nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msha_gnn_tpu.graph as jg
import msha_gnn_torch.graph as tg
from msha_gnn_tpu.ops.pallas.softmax import \
    SegmentSoftmaxOperator as JaxSoftmax
from msha_gnn_torch.ops.cuda import softmax as sm
from msha_gnn_torch.ops.cuda import spmm as cuda_spmm


def graphs(seed, n_src, n_dst, density, empty_rows=(), hub=None):
    """Both packages' graph of a random 0/1..4 adjacency, ``empty_rows``
    emptied and row ``hub`` full, edges padded to a multiple of 16."""
    rng = np.random.default_rng(seed)
    dense = ((rng.random((n_src, n_dst)) < density)
             * rng.integers(1, 5, (n_src, n_dst))).astype(np.float32)
    dense[list(empty_rows)] = 0.0
    if hub is not None:
        dense[hub] = 1.0
    return (tg.BipartiteGraph.from_dense(dense, pad_to_multiple=16),
            jg.BipartiteGraph.from_dense(dense, pad_to_multiple=16))


@pytest.mark.parametrize("case", [
    # n_src not a multiple of 128, empty rows first, in the middle, last
    dict(seed=0, n_src=300, n_dst=120, density=0.05,
         empty_rows=(0, 1, 151, 298, 299)),
    # one row of 400 edges across the JAX operator's 128-slot chunks
    dict(seed=1, n_src=40, n_dst=400, density=0.02, empty_rows=(5,),
         hub=20),
])
def test_broadcast_rows_matches_jax(case):
    gt, gj = graphs(**case)
    n, e, e_pad = gt.n_src, gt.num_edges, gt.num_padded_edges
    assert e_pad > e   # pads to broadcast as 0
    rng = np.random.default_rng(case["seed"])
    v = rng.standard_normal(n).astype(np.float32)
    g = rng.integers(-8, 9, e_pad).astype(np.float32)

    jop = JaxSoftmax(np.asarray(gj.senders), np.asarray(gj.row_ptr), n,
                     interpret=True)
    out_j, vjp = jax.vjp(jop.broadcast_rows, jnp.asarray(v))
    (dv_j,) = vjp(jnp.asarray(g))

    op = sm.SegmentSoftmaxOperator(gt.senders, gt.row_ptr, n, device="cpu")
    before = (sm.expand_launches, cuda_spmm.seg_launches)
    vt = torch.from_numpy(v).requires_grad_()
    out = op.broadcast_rows(vt)
    out.backward(torch.from_numpy(g))
    assert (sm.expand_launches, cuda_spmm.seg_launches) == before
    assert out.shape == (e_pad,) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(vt.grad.numpy(), np.asarray(dv_j))
    assert not out[e:].any()
    # the forward is v at each edge's sender
    np.testing.assert_array_equal(out[:e].detach().numpy(),
                                  v[gt.senders[:e].numpy()])


def test_broadcast_rows_of_a_graph_without_pads():
    """The out-of-core path's operator: every slot an edge (no pads), the
    sorted senders as given to ``train_chunked``."""
    rng = np.random.default_rng(4)
    s = np.sort(rng.integers(0, 50, 700)).astype(np.int32)
    ptr = np.concatenate([[0], np.cumsum(np.bincount(s, minlength=50))])
    v = rng.standard_normal(50).astype(np.float32)
    g = rng.integers(-8, 9, 700).astype(np.float32)
    jop = JaxSoftmax(s, ptr, 50, interpret=True)
    out_j, vjp = jax.vjp(jop.broadcast_rows, jnp.asarray(v))
    op = sm.SegmentSoftmaxOperator(s, ptr, 50, device="cpu")
    vt = torch.from_numpy(v).requires_grad_()
    out = op.broadcast_rows(vt)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(vt.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(g))[0]))


def test_seg_expand_plain_and_checks():
    ptr = torch.tensor([0, 0, 3, 3, 5], dtype=torch.int32)
    v = torch.tensor([1.0, 2.0, 3.0, 4.0])
    got = sm.seg_expand(ptr, v, 8, 5)
    assert got.tolist() == [2.0, 2.0, 2.0, 4.0, 4.0, 0.0, 0.0, 0.0]
    op = sm.SegmentSoftmaxOperator(torch.zeros(8, dtype=torch.int32), ptr, 4,
                                   device="cpu")
    with pytest.raises(ValueError, match="must be"):
        op.broadcast_rows(torch.zeros(5))
