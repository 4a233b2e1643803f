"""The port's flash-GAT operator against the JAX package's.

The JAX side runs as its own tests run it on the CPU:
``FlashGATOperator.build(g, interpret=True, dropout_rate=rate)``, whose
Pallas kernels ``_flash_kernel`` and ``_flash_bwd_kernel`` run in interpret
mode.  The port's ``FlashGatOperator`` runs the plain versions of its
kernels on CPU tensors, with the operator's own bookkeeping (autograd, the
dropout seed, the ``q``-weighted transposed SpMM of ``dx``) under test.

Tolerance: rtol 1e-4 and an atol of 1e-5 of the largest reference value
for the output and ``dx``, 1e-4 of it for ``dlogits``.  The Pallas side
multiplies through a bf16 hi/lo split with the lo*lo term dropped
(``flash_gat.py:93-102``, ``:219-222``), about 2^-16 relative a product;
the port keeps f32.  ``dlogits`` is the difference of two such products,
``q <g, x> - att <g, out>``, which cancel where one edge holds a row's
attention: against a float64 run of the port's plain versions the JAX
``dlogits`` is off by up to 4.3e-5 of its largest value (logits x30), the
port's by 9e-7.  The keep mask is the same hash of ``(seed, CSR edge
index)`` on both sides, so the masks agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msha_gnn_tpu.graph as jg
import msha_gnn_torch.graph as tg
from msha_gnn_tpu.ops.pallas import FlashGATOperator as JaxFlash
from msha_gnn_torch.ops import edge_softmax, spmm
from msha_gnn_torch.ops.cuda import flash_gat as fg
from msha_gnn_torch.ops.cuda import spmm as cuda_spmm
from msha_gnn_torch.ops.cuda.rank1_gat import NEG

RTOL, ATOL_REL, DL_ATOL_REL = 1e-4, 1e-5, 1e-4
SEED = -123457


def close(got, want, name, atol_rel=ATOL_REL):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=atol_rel * float(np.abs(want).max()),
                               err_msg=name)


def random_graphs(seed, n_src, n_dst, density, empty_rows=()):
    rng = np.random.default_rng(seed)
    dense = ((rng.random((n_src, n_dst)) < density)
             * rng.integers(1, 5, (n_src, n_dst))).astype(np.float32)
    dense[list(empty_rows)] = 0.0
    return (tg.BipartiteGraph.from_dense(dense, pad_to_multiple=16),
            jg.BipartiteGraph.from_dense(dense, pad_to_multiple=16))


def skewed_graphs(seed):
    """The skewed graph of ``tests/test_flash_gat.py``: rows 0 and 150 hold
    most edges, rows 200 and up none, n_src 300 (not a multiple of 128)."""
    rng = np.random.default_rng(seed)
    n_src, n_dst, e = 300, 70, 1500
    senders = np.sort(rng.choice([0, 1, 127, 128, 150, 199], e,
                                 p=[.4, .1, .1, .1, .25, .05]))
    receivers = rng.integers(0, n_dst, e)
    w = np.ones(e, np.float32)
    return (tg.BipartiteGraph.from_coo(senders, receivers, w, n_src=n_src,
                                       n_dst=n_dst),
            jg.BipartiteGraph.from_coo(senders, receivers, w, n_src=n_src,
                                       n_dst=n_dst))


# name -> (graphs, feature width, logit scale)
CASES = {
    "random": (lambda: random_graphs(0, 150, 60, 0.12, empty_rows=(7,)), 16,
               3.0),
    # the online renormalisation under a large logit range, empty rows
    "extreme": (lambda: random_graphs(1, 300, 40, 0.05,
                                      empty_rows=(0, 151, 299)), 8, 30.0),
    "skewed": (lambda: skewed_graphs(2), 8, 1.0),
}


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_operator_matches_pallas(case, rate):
    make, d, scale = CASES[case]
    gt, gj = make()
    np.testing.assert_array_equal(gt.senders.numpy(), np.asarray(gj.senders))
    np.testing.assert_array_equal(gt.receivers.numpy(),
                                  np.asarray(gj.receivers))
    rng = np.random.default_rng(len(case))
    e_pad = gt.num_padded_edges
    logits = (rng.standard_normal(e_pad) * scale).astype(np.float32)
    x = rng.standard_normal((gt.n_dst, d)).astype(np.float32)
    ct = rng.standard_normal((gt.n_src, d)).astype(np.float32)

    jop = JaxFlash.build(gj, interpret=True, dropout_rate=rate)
    seed_j = jnp.asarray([SEED], jnp.int32)

    def jax_fn(l, x):
        return jop.drop(l, x, seed_j) if rate else jop(l, x)

    want, vjp = jax.vjp(jax_fn, jnp.asarray(logits), jnp.asarray(x))
    want_dl, want_dx = (np.asarray(v) for v in vjp(jnp.asarray(ct)))

    op = fg.FlashGatOperator(gt, dropout_rate=rate)
    ins = [torch.from_numpy(v).requires_grad_() for v in (logits, x)]
    before = (fg.fwd_launches, fg.bwd_launches, cuda_spmm.launches)
    got = (op.drop(*ins, torch.tensor([SEED], dtype=torch.int32)) if rate
           else op(*ins))
    close(got.detach().numpy(), np.asarray(want), "out")
    got.backward(torch.from_numpy(ct))
    mask = gt.edge_mask.numpy()
    close(ins[0].grad.numpy()[mask], want_dl[mask], "dlogits", DL_ATOL_REL)
    close(ins[1].grad.numpy(), want_dx, "dx")
    # the port's pad slots get no gradient
    assert not ins[0].grad[~gt.edge_mask].any()
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (fg.fwd_launches, fg.bwd_launches, cuda_spmm.launches) == before
    # empty rows give zeros
    empty = (gt.row_ptr[1:] == gt.row_ptr[:-1]).numpy()
    assert empty.any() and not got.detach().numpy()[empty].any()


def test_plain_versions_are_the_pipeline_and_its_autograd():
    """``flash_gat_plain`` equals the plain row softmax then the weighted
    SpMM, with dropout; ``flash_gat_bwd_plain`` plus the ``q``-weighted
    transposed SpMM equals torch's autograd through it.  In float64: the
    autograd path carries the softmax's max and sum terms, which cancel
    only up to rounding."""
    gt, _ = random_graphs(4, 200, 80, 0.06, empty_rows=(5, 199))
    op = cuda_spmm.SpmmOperator(gt, device="cpu")
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.standard_normal(gt.num_padded_edges) * 2)
    x = torch.from_numpy(rng.standard_normal((80, 16)))
    gout = torch.from_numpy(rng.standard_normal((200, 16)))
    seed, rate = torch.tensor([7], dtype=torch.int32), 0.5
    keep = fg._keep(gt.num_padded_edges, seed, rate, "cpu").double()

    l_ref, x_ref = logits.clone().requires_grad_(), x.clone().requires_grad_()
    att = edge_softmax(gt, l_ref) * keep
    want = spmm(gt, x_ref, edge_weight=att)
    want.backward(gout)

    l_in, x_in = logits.clone().requires_grad_(), x.clone().requires_grad_()
    out, lse = fg.flash_gat_plain(op.ptr, op.col, l_in, x_in, seed, rate,
                                  200)
    torch.testing.assert_close(out, want, rtol=1e-10, atol=1e-12)
    assert bool((lse[[5, 199]] == NEG).all())
    out.backward(gout)
    dl, q = fg.flash_gat_bwd_plain(op.ptr, op.col, logits, x, gout,
                                   out.detach(), lse, seed, rate, 200)
    dx = op.apply(gout, q, transpose=True)
    for got, ref, auto in ((dl, l_ref.grad, l_in.grad),
                           (dx, x_ref.grad, x_in.grad)):
        torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-12)
        torch.testing.assert_close(got, auto, rtol=1e-10, atol=1e-12)
    e = gt.num_edges
    assert not dl[e:].any() and not q[e:].any()
    torch.testing.assert_close(q[:e], (att.detach())[:e], rtol=1e-12,
                               atol=0.0)


def test_drop_at_rate_zero_equals_call_and_rate_one_raises():
    gt, _ = random_graphs(2, 90, 40, 0.1)
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(
        rng.standard_normal(gt.num_padded_edges).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((40, 8)).astype(np.float32))
    op = fg.FlashGatOperator(gt)
    assert torch.equal(op.drop(logits, x, torch.tensor([99],
                                                       dtype=torch.int32)),
                       op(logits, x))
    assert torch.equal(fg.flash_gat_aggregate(gt, logits, x), op(logits, x))
    for rate in (1.0, 1.5):
        with pytest.raises(ValueError, match="dropout_rate"):
            fg.FlashGatOperator(gt, dropout_rate=rate)
    with pytest.raises(ValueError, match="logits"):
        op(logits[:-1], x)
