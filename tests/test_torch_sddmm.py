"""The port's SDDMM against the JAX package's.

The JAX side runs ``SddmmOperator.build(..., interpret=True)``: the Pallas
kernels ``_sddmm_kernel`` and ``_sddmm_hub_kernel`` (the hub split on the
skewed graph below) in interpret mode, and for the VJP the Pallas SpMM.
The port's operator runs the plain version of ``csr_sddmm_f32`` on CPU
tensors, its backward the SpMM operator's.

Tolerance rtol 1e-4, atol 1e-5: the Pallas f32 SDDMM gathers the sorted
side through a bf16 hi/lo split (``spmm.py:1446-1450``), about 2^-16
relative to each term, so the inputs are non-negative (no sum cancels).
``sddmm_dot(impl="torch")`` against the JAX XLA formulation takes signed
inputs at rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msha_gnn_tpu.graph as jg
import msha_gnn_torch.graph as tg
from msha_gnn_tpu.ops import sddmm_dot as jax_sddmm_dot
from msha_gnn_tpu.ops.pallas import SddmmOperator as JaxSddmm
from msha_gnn_torch.ops import sddmm_dot
from msha_gnn_torch.ops.cuda import sddmm as sd
from tests.test_torch_spmm import skewed_coo

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def graphs():
    src, dst, w = skewed_coo(4, n_src=260, n_dst=130, e=2200)
    kw = dict(n_src=260, n_dst=130, pad_to_multiple=128)
    return (tg.BipartiteGraph.from_coo(src, dst, w, **kw),
            jg.BipartiteGraph.from_coo(src, dst, w, **kw))


@pytest.mark.parametrize("d", [16, 129])
def test_operator_matches_pallas(graphs, d):
    gt, gj = graphs
    rng = np.random.default_rng(d)
    h_src = rng.random((gt.n_src, d)).astype(np.float32)
    h_dst = rng.random((gt.n_dst, d)).astype(np.float32)
    ct = rng.random(gt.num_padded_edges).astype(np.float32)
    jop = JaxSddmm.build(gj, interpret=True)
    want, vjp = jax.vjp(jop, jnp.asarray(h_src), jnp.asarray(h_dst))
    want_grads = vjp(jnp.asarray(ct))

    op = sd.SddmmOperator(gt)
    ins = [torch.from_numpy(v).requires_grad_() for v in (h_src, h_dst)]
    before = sd.launches
    got = op(*ins)
    assert got.shape == (gt.num_padded_edges,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    assert not got.detach()[gt.num_edges:].any()    # pads are 0
    got.backward(torch.from_numpy(ct))
    for name, t, w in zip(("dh_src", "dh_dst"), ins, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    assert sd.launches == before                     # the CPU: plain version


def test_sddmm_dot_impls_match_jax(graphs):
    gt, gj = graphs
    rng = np.random.default_rng(5)
    a = rng.standard_normal((gt.n_src, 24)).astype(np.float32)
    b = rng.standard_normal((gt.n_dst, 24)).astype(np.float32)
    want = np.asarray(jax_sddmm_dot(gj, jnp.asarray(a), jnp.asarray(b)))
    for impl in ("torch", "cuda"):
        got = sddmm_dot(gt, torch.from_numpy(a), torch.from_numpy(b),
                        impl=impl)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=impl)
    with pytest.raises(ValueError, match="unknown sddmm_dot impl"):
        sddmm_dot(gt, torch.from_numpy(a), torch.from_numpy(b), impl="xla")


def test_plain_version_with_empty_rows_and_shape_checks():
    rng = np.random.default_rng(6)
    dense = (rng.random((40, 9)) < 0.3).astype(np.float32)
    dense[[0, 17, 39]] = 0.0
    g = tg.BipartiteGraph.from_dense(dense, pad_to_multiple=16)
    a = torch.from_numpy(rng.standard_normal((40, 5)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((9, 5)).astype(np.float32))
    op = sd.SddmmOperator(g)
    got = sd.csr_sddmm(op.spmm.ptr, op.spmm.col, a, b, g.num_padded_edges)
    s, r = g.senders[: g.num_edges].long(), g.receivers[: g.num_edges].long()
    want = (a @ b.T)[s, r]
    torch.testing.assert_close(got[: g.num_edges], want, rtol=1e-6,
                               atol=1e-6)
    assert not got[g.num_edges:].any()
    with pytest.raises(ValueError, match="h_src must be"):
        op(a[:-1], b)
    with pytest.raises(ValueError, match="widths differ"):
        op(a, b[:, :4])
