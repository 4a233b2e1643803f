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

The rank-1 logits ``sddmm(impl="cuda")`` and ``rank1_logits_fn`` (the
operator on width-2 columns) are held against ``sddmm_pallas`` and the JAX
``rank1_logits_fn`` the same way; the ``.build`` methods, the one-shot
wrappers and ``msha_gnn_torch.ops.cuda``'s lazy export list against their
JAX counterparts and the plain versions.
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


def _rank1_inputs(g, seed):
    """Non-negative scores (no sum cancels against the Pallas hi/lo split)
    and a non-negative cotangent."""
    rng = np.random.default_rng(seed)
    return (rng.random(g.n_src).astype(np.float32),
            rng.random(g.n_dst).astype(np.float32),
            rng.random(g.num_padded_edges).astype(np.float32))


@pytest.mark.parametrize("num_edges", [None, "real"])
def test_rank1_logits_match_pallas(graphs, num_edges):
    """``sddmm(impl="cuda")`` (its CPU route: the operator on the plain
    ``csr_sddmm_f32``) and ``rank1_logits_fn`` against ``sddmm_pallas`` and
    the JAX ``rank1_logits_fn`` over ``SddmmOperator.build(graph,
    interpret=True)``, values and both gradients."""
    from msha_gnn_tpu.ops.pallas.sddmm import \
        rank1_logits_fn as jax_rank1_logits_fn
    from msha_gnn_tpu.ops.pallas.sddmm import sddmm_pallas
    from msha_gnn_torch.ops import sddmm

    gt, gj = graphs
    s_src, s_dst, ct = _rank1_inputs(gt, 7)
    n = None if num_edges is None else gt.num_edges
    if n is None:
        jfn = lambda u, v: sddmm_pallas(gj, u, v, negative_slope=0.3,  # noqa
                                        interpret=True)
        tfn = lambda u, v: sddmm(gt, u, v, negative_slope=0.3,  # noqa
                                 impl="cuda")
    else:
        ct = ct[:n]
        jfn = jax_rank1_logits_fn(JaxSddmm.build(gj, interpret=True),
                                  num_edges=n, negative_slope=0.3)
        tfn = sd.rank1_logits_fn(sd.SddmmOperator.build(gt), num_edges=n,
                                 negative_slope=0.3)
    want, vjp = jax.vjp(jfn, jnp.asarray(s_src), jnp.asarray(s_dst))
    want_grads = vjp(jnp.asarray(ct))
    ins = [torch.from_numpy(v).requires_grad_() for v in (s_src, s_dst)]
    before = sd.launches
    got = tfn(*ins)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    got.backward(torch.from_numpy(ct))
    for name, t_, w in zip(("ds_src", "ds_dst"), ins, want_grads):
        np.testing.assert_allclose(t_.grad.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    assert sd.launches == before                     # the CPU: plain version


def test_sddmm_cuda_route_equals_plain_logits(graphs):
    """Signed scores, both leaky_relu branches: the width-2 dot
    ``s * 1 + 1 * t`` is the plain sum bit for bit; pads are 0 where the
    plain path leaves them unspecified; an unknown impl raises."""
    from msha_gnn_torch.ops import sddmm

    gt, _ = graphs
    rng = np.random.default_rng(8)
    s = torch.from_numpy(rng.standard_normal(gt.n_src).astype(np.float32))
    t = torch.from_numpy(rng.standard_normal(gt.n_dst).astype(np.float32))
    got = sddmm(gt, s, t, impl="cuda")
    want = sddmm(gt, s, t)
    e = gt.num_edges
    assert torch.equal(got[:e], want[:e]) and (want[:e] < 0).any()
    assert not got[e:].any()
    with pytest.raises(ValueError, match="unknown sddmm impl"):
        sddmm(gt, s, t, impl="pallas")


def test_build_methods_wrappers_and_alias(graphs):
    """``.build`` on the three operators (the JAX signatures less
    ``interpret``), the one-shot wrappers, the ``FlashGATOperator``
    spelling and the package's export list against ``ops/pallas``'s."""
    import msha_gnn_tpu.ops.pallas as jax_pallas
    import msha_gnn_torch.ops.cuda as cuda
    from msha_gnn_torch.ops import edge_softmax, segment_softmax, spmm
    from msha_gnn_torch.ops.cuda import flash_gat as fgat
    from msha_gnn_torch.ops.cuda import rank1_gat as r1
    from msha_gnn_torch.ops.cuda.spmm import SpmmOperator

    gt, _ = graphs
    own = SpmmOperator.build(gt)
    op = cuda.SddmmOperator.build(gt, own)
    assert isinstance(op, sd.SddmmOperator) and op.spmm is own
    assert cuda.SddmmOperator.build(gt).spmm is not own  # the cached one
    lin = cuda.Rank1GatOperator.build(gt, own, negative_slope=0.1,
                                      dst_linear=True, dropout_rate=0.5)
    assert (lin.spmm, lin.slope, lin.dst_linear, lin.dropout_rate) == (
        own, 0.1, True, 0.5)
    gen16 = cuda.Rank1GatOperator.build(gt, precision="bf16")
    assert (gen16.precision, gen16.dst_linear) == ("bf16", False)
    flash = cuda.FlashGATOperator.build(gt, own, dropout_rate=0.25)
    assert cuda.FlashGATOperator is fgat.FlashGatOperator is \
        cuda.FlashGatOperator
    assert flash.spmm is own and flash.dropout_rate == 0.25
    assert r1.Rank1GatOperator.build(gt).spmm is \
        fgat.FlashGatOperator.build(gt).spmm

    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.standard_normal((gt.n_src, 6)).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal((gt.n_dst, 6)).astype(
        np.float32))
    torch.testing.assert_close(cuda.sddmm_dot_cuda(gt, a, b),
                               sddmm_dot(gt, a, b), rtol=1e-6, atol=1e-6)
    logits = torch.from_numpy(rng.standard_normal(
        gt.num_padded_edges).astype(np.float32))
    torch.testing.assert_close(cuda.edge_softmax_cuda(gt, logits),
                               edge_softmax(gt, logits, impl="cuda"),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        cuda.edge_softmax_cuda(gt, logits),
        segment_softmax(logits, gt.senders, gt.n_src, mask=gt.edge_mask),
        rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(cuda.spmm_cuda(gt, b), spmm(gt, b),
                               rtol=1e-5, atol=1e-5)
    x = torch.from_numpy(rng.random((gt.n_dst, 4)).astype(np.float32))
    torch.testing.assert_close(
        cuda.flash_gat_aggregate(gt, logits, x),
        spmm(gt, x, edge_weight=edge_softmax(gt, logits)),
        rtol=1e-5, atol=1e-6)
    want = {n.replace("_pallas", "_cuda") for n in jax_pallas.__all__}
    assert want <= set(cuda.__all__)
    assert set(cuda.__all__) <= set(dir(cuda))
    with pytest.raises(AttributeError):
        cuda.no_such_name  # noqa: B018


def test_importing_the_kernel_package_loads_nothing():
    """``import msha_gnn_torch.ops.cuda`` and every name it exports build
    and load no library: ``_build`` is not even imported until a launch."""
    import subprocess
    import sys
    import textwrap

    script = textwrap.dedent("""
        import sys
        import msha_gnn_torch.ops.cuda as cuda
        for name in cuda.__all__:
            getattr(cuda, name)
        from msha_gnn_torch.ops.cuda import (flash_gat, rank1_gat, sddmm,
                                             softmax, spmm)
        assert "msha_gnn_torch.ops.cuda._build" not in sys.modules
        for mod in (flash_gat, rank1_gat, sddmm, softmax, spmm):
            assert mod._lib is None, mod
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", script],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
