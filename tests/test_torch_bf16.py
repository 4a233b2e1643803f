"""The port's bfloat16 payload against the JAX package's, on the CPU:
``spmm(precision="bf16")``, ``Rank1GatOperator(precision="bf16",
dst_linear=True)``, ``SparseGATLayer(self_concat=True)`` and
``SparseGAT(precision="bf16")``.

The port's contract: the rows are stored and streamed in bfloat16 (``x``
in the forward, the cotangent in ``dx``'s transposed gather) and every
product, logit, softmax and sum is float32.  Its plain versions define
that contract exactly, so they are held against a float64 computation of
it at 1e-6 (of each result's largest value, and relative), and the CPU
operators, which run the kernels' plain versions, against them.

The JAX bf16 functions round at other points of their schedule (the
visit SpMM rounds ``v * w``, the hub SpMM the per-hub sums, the rank-1
kernels the unnormalised ``p``), so the port is held against them at the
JAX tests' own bounds: 2e-2 of the float32 result's largest value for
the operators (``tests/test_pallas_spmm.py:464-482``), 3e-2 for
``SparseGAT`` (``:485-505``).  The JAX Pallas operators run in interpret
mode.  ``self_concat`` is float32: rtol 1e-5, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msha_gnn_tpu.graph as jg
import msha_gnn_torch.graph as tg
from msha_gnn_tpu.models import SparseGAT as JaxSparseGAT
from msha_gnn_tpu.models.gat import SparseGATLayer as JaxLayer
from msha_gnn_tpu.ops.pallas.rank1_gat import Rank1GatOperator as JaxRank1
from msha_gnn_tpu.ops.pallas.spmm import SpmmOperator as JaxSpmm
from msha_gnn_torch.models import (SparseGAT, SparseGATLayer,
                                   sparse_gat_layer_params_from_jax)
from msha_gnn_torch.ops import spmm
from msha_gnn_torch.ops.cuda.rank1_gat import Rank1GatOperator
from msha_gnn_torch.ops.cuda.spmm import SpmmOperator
from tests.test_torch_gat_layer import rect_graphs

JAX_TOL = 2e-2       # of the float32 result's max: the JAX operator tests
GAT_TOL = 3e-2       # of the float32 result's max: the JAX SparseGAT test
EXACT = 1e-6         # the port's plain bf16 against float64 of its contract
SELF_RTOL, SELF_ATOL = 1e-5, 1e-6


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def bf16(a) -> np.ndarray:
    """``a`` rounded to bfloat16, as float64."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).double().numpy()


def near(got, want, tol, err_msg=""):
    """|got - want| within ``tol`` of want's largest value."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=err_msg)


def exact(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=EXACT,
                               atol=EXACT * np.abs(want).max(),
                               err_msg=err_msg)


@pytest.fixture(scope="module")
def skewed():
    """Both packages' graph of 3,000 edges over 200 x 300 with hub columns
    (p ~ 1 / rank^1.3), duplicates summed, and its COO in numpy."""
    rng = np.random.default_rng(11)
    p = 1.0 / np.arange(1, 301) ** 1.3
    src = rng.integers(0, 200, 3000)
    dst = rng.choice(300, 3000, p=p / p.sum())
    w = rng.standard_normal(3000).astype(np.float32)
    kw = dict(n_src=200, n_dst=300, pad_to_multiple=128)
    gt = tg.BipartiteGraph.from_coo(src, dst, w, **kw)
    gj = jg.BipartiteGraph.from_coo(src, dst, w, **kw)
    return gt, gj, rng


def draws(g, rng, transpose, d=16):
    n_in, n_out = (g.n_src, g.n_dst) if transpose else (g.n_dst, g.n_src)
    x = rng.standard_normal((n_in, d)).astype(np.float32)
    w = rng.random(g.num_padded_edges).astype(np.float32)
    cot = rng.standard_normal((n_out, d)).astype(np.float32)
    return x, w, cot


def port_vjp(fn, x, w, cot):
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = fn(xt, wt)
    out.backward(torch.from_numpy(cot))
    return out, xt.grad, wt.grad


def contract(g, x, w, cot, transpose):
    """The port's bf16 SpMM in float64: ``(out, dx, dw)`` over the real
    edges, ``x`` and the cotangent rounded to bfloat16."""
    e = g.num_edges
    s = _np(g.senders)[:e].astype(np.int64)
    r = _np(g.receivers)[:e].astype(np.int64)
    src, dst = (r, s) if transpose else (s, r)    # out rows, gathered rows
    xb, gb, ww = bf16(x), bf16(cot), w[:e].astype(np.float64)
    out = np.zeros(cot.shape)
    np.add.at(out, src, ww[:, None] * xb[dst])
    dx = np.zeros(x.shape)
    np.add.at(dx, dst, ww[:, None] * gb[src])
    dw = np.zeros(len(w))
    dw[:e] = (gb[src] * xb[dst]).sum(1)
    return out, dx, dw


@pytest.mark.parametrize("transpose", [False, True])
def test_plain_bf16_spmm_is_its_contract(skewed, transpose):
    """``impl="torch"`` and the operator's plain path (``fused_bwd`` off
    and on) against float64 of the contract at 1e-6."""
    gt, _, rng = skewed
    x, w, cot = draws(gt, rng, transpose)
    want = contract(gt, x, w, cot, transpose)
    fns = {"torch": lambda a, b: spmm(gt, a, edge_weight=b,
                                      transpose=transpose, precision="bf16"),
           "cuda": lambda a, b: spmm(gt, a, edge_weight=b, impl="cuda",
                                     transpose=transpose, precision="bf16")}
    for fused in (False, True):
        op = SpmmOperator(gt, "cpu", fused_bwd=fused, precision="bf16")
        fns[f"operator fused_bwd={fused}"] = (
            lambda a, b, op=op: op(a, edge_weight=b, transpose=transpose))
    for name, fn in fns.items():
        for got, ref, what in zip(port_vjp(fn, x, w, cot), want,
                                  ("out", "dx", "dw")):
            exact(got, ref, f"{name} {what}")


@pytest.mark.parametrize("hub_split", [128, 0])
@pytest.mark.parametrize("transpose", [False, True])
def test_bf16_spmm_matches_the_jax_operator(skewed, hub_split, transpose):
    """Forward, ``dx`` and ``dw`` against the JAX bf16 ``SpmmOperator`` at
    2e-2 of the float32 result's max; the real edges' ``dw``."""
    gt, gj, rng = skewed
    x, w, cot = draws(gt, rng, transpose)
    e = gt.num_edges
    op_j = JaxSpmm.build(gj, interpret=True, precision="bf16",
                         hub_split=hub_split)
    out_j, vjp = jax.vjp(
        lambda a, b: op_j(a, edge_weight=b, transpose=transpose),
        jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(cot))
    f32 = port_vjp(lambda a, b: spmm(gt, a, edge_weight=b,
                                     transpose=transpose), x, w, cot)
    got = port_vjp(lambda a, b: spmm(gt, a, edge_weight=b,
                                     transpose=transpose, precision="bf16"),
                   x, w, cot)
    for g_, j, ref, what in zip(got, (out_j, dx_j, dw_j), f32,
                                ("out", "dx", "dw")):
        if what == "dw":
            g_, j, ref = _np(g_)[:e], np.asarray(j)[:e], _np(ref)[:e]
        tol = JAX_TOL * np.abs(_np(ref)).max()
        np.testing.assert_allclose(_np(g_), np.asarray(j), rtol=0, atol=tol,
                                   err_msg=what)
        assert np.abs(_np(g_) - _np(ref)).max() <= tol, what


def rank1_inputs(seed, gt, d=16):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal(gt.n_src).astype(np.float32)
    a = rng.standard_normal(d).astype(np.float32) * 0.3
    x = rng.standard_normal((gt.n_dst, d)).astype(np.float32)
    cot = rng.standard_normal((gt.n_src, d)).astype(np.float32)
    return c, a, x, cot


SEED = -98765


def port_rank1(op, c, a, x, cot, rate):
    ts = [torch.from_numpy(v).requires_grad_() for v in (c, a, x)]
    seed = torch.tensor([SEED], dtype=torch.int32)
    out = op.drop(*ts, seed) if rate > 0 else op(*ts)
    out.backward(torch.from_numpy(cot))
    return (out,) + tuple(t.grad for t in ts)


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_bf16_rank1_matches_jax(skewed, rate):
    """The plain ``Rank1GatOperator(precision="bf16", dst_linear=True)``:
    forward and ``(dc, da, dx)`` against the JAX bf16 operator at 2e-2 of
    the float32 result's max (the same keep mask: the hash of ``(seed,
    slot)``)."""
    gt, gj, _ = skewed
    c, a, x, cot = rank1_inputs(3, gt)
    op_j = JaxRank1.build(gj, interpret=True, precision="bf16",
                          dst_linear=True, dropout_rate=rate)
    seed_j = jnp.asarray([SEED], jnp.int32)
    fn = ((lambda *v: op_j.drop(*v, seed_j)) if rate > 0
          else (lambda *v: op_j(*v)))
    out_j, vjp = jax.vjp(fn, jnp.asarray(c), jnp.asarray(a), jnp.asarray(x))
    want = (out_j,) + vjp(jnp.asarray(cot))
    f32 = port_rank1(Rank1GatOperator(gt, dst_linear=True,
                                      dropout_rate=rate), c, a, x, cot, rate)
    got = port_rank1(Rank1GatOperator(gt, precision="bf16", dst_linear=True,
                                      dropout_rate=rate), c, a, x, cot, rate)
    for g_, j, ref, what in zip(got, want, f32, ("out", "dc", "da", "dx")):
        np.testing.assert_allclose(_np(g_), np.asarray(j), rtol=0,
                                   atol=JAX_TOL * np.abs(_np(ref)).max(),
                                   err_msg=what)
    # the gradients are not held to float32's: where the rounding of a row
    # moves a logit across 0, the leaky slope of that edge's dpre flips,
    # in both packages alike
    near(got[0], f32[0], JAX_TOL)


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_plain_bf16_rank1_is_its_contract(skewed, rate):
    """The bf16 operator is the float32 one on the rounded rows: the same
    forward, ``dc`` and ``da`` bit for bit, and ``dx`` from the rounded
    cotangent (the ``q``-weighted gather streams it in bfloat16)."""
    gt, _, _ = skewed
    c, a, x, cot = rank1_inputs(4, gt)
    xb = bf16(x).astype(np.float32)
    got = port_rank1(Rank1GatOperator(gt, precision="bf16", dst_linear=True,
                                      dropout_rate=rate), c, a, x, cot, rate)
    f32 = port_rank1(Rank1GatOperator(gt, dst_linear=True,
                                      dropout_rate=rate), c, a, xb, cot, rate)
    for i, what in enumerate(("out", "dc", "da")):
        np.testing.assert_array_equal(_np(got[i]), _np(f32[i]), what)
    # dx = sum_e (q_e bf16(g)[r_e] + dpre_e a): the float32 operator's dx
    # less its q-weighted gather of g, plus that gather of bf16(g)
    dpre_term = _np(f32[3]) - _np(spmm_q(gt, c, a, xb, cot, rate))
    exact(got[3], dpre_term + _np(spmm_q(gt, c, a, xb, bf16(cot), rate)),
          "dx")
    assert not np.array_equal(_np(got[3]), _np(f32[3]))


def spmm_q(gt, c, a, x, cot, rate):
    """``sum_{e: col_e = j} q_e g[r_e]`` for the float32 operator's
    ``q``."""
    from msha_gnn_torch.ops.cuda import rank1_gat as r1

    op = SpmmOperator(gt, "cpu")
    seed = torch.tensor([SEED], dtype=torch.int32)
    t = {k: torch.from_numpy(np.asarray(v, np.float32))
         for k, v in dict(c=c, a=a, x=x, g=cot).items()}
    out, lse = r1.r1l_fwd(op.ptr, op.col, t["c"], t["a"], t["x"], seed, rate,
                          0.2, gt.n_src)
    q, *_ = r1.r1l_bwd(op.ptr, op.col, t["c"], t["a"], t["x"], t["g"], out,
                       lse, seed, rate, 0.2, gt.n_src)
    return op.apply(t["g"], q, transpose=True)


def test_generic_bf16_raises(skewed):
    """The generic form takes ``precision="bf16"`` now
    (``tests/test_torch_generic_bf16.py``); an unknown precision raises
    everywhere."""
    gt = skewed[0]
    op = Rank1GatOperator(gt, precision="bf16")
    assert op.precision == "bf16" and not op.dst_linear
    with pytest.raises(ValueError, match="precision"):
        Rank1GatOperator(gt, precision="f16")
    with pytest.raises(ValueError, match="precision"):
        Rank1GatOperator(gt, precision="f16", dst_linear=True)
    with pytest.raises(ValueError, match="precision"):
        SparseGATLayer(4, 4, precision="f16")
    with pytest.raises(ValueError, match="precision"):
        spmm(gt, torch.zeros(gt.n_dst, 2), precision="f16")


@pytest.mark.parametrize("impl", ["torch", "fused"])
def test_self_concat_layer_matches_jax(impl):
    """``SparseGATLayer(self_concat=True)`` on a 30 x 12 graph against the
    JAX layer's XLA path at float32 tolerance."""
    gt, gj, rng = rect_graphs(7)
    x_src = rng.standard_normal((30, 6)).astype(np.float32)
    x_dst = rng.standard_normal((12, 6)).astype(np.float32)
    layer_j = JaxLayer(6, 5, dropout=0.0, self_concat=True)
    params = layer_j.init(jax.random.PRNGKey(1), gj, jnp.asarray(x_src),
                          jnp.asarray(x_dst), train=False)
    want = layer_j.apply(params, gj, jnp.asarray(x_src), jnp.asarray(x_dst),
                         train=False)
    layer = SparseGATLayer(6, 5, dropout=0.0, self_concat=True)
    layer.load_state_dict(sparse_gat_layer_params_from_jax(params))
    got = layer(gt, torch.from_numpy(x_src), torch.from_numpy(x_dst),
                train=False, impl=impl)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=SELF_RTOL,
                               atol=SELF_ATOL)
    plain = SparseGATLayer(6, 5, dropout=0.0)
    plain.load_state_dict(layer.state_dict())
    assert not torch.allclose(plain(gt, torch.from_numpy(x_src),
                                    torch.from_numpy(x_dst), train=False),
                              got)


@pytest.mark.parametrize("impl", ["torch", "fused", "materialised"])
def test_bf16_sparse_gat_matches_jax(impl):
    """``SparseGAT(precision="bf16")`` against the JAX bf16 model (XLA
    path) at 3e-2 of the float32 embeddings' max, with finite gradients;
    ``flash`` ignores the precision (its kernels have no bf16 mode)."""
    gt, gj, rng = rect_graphs(8, n_src=60, n_dst=60, n_edges=500)
    x = rng.standard_normal((60, 12)).astype(np.float32)
    kw = dict(in_features=12, hidden=8, out_features=8, n_heads=2,
              dropout=0.0)
    m32 = JaxSparseGAT(**kw)
    variables = m32.init(jax.random.key(0), gj, jnp.asarray(x), train=False)
    z32 = np.asarray(m32.apply(variables, gj, jnp.asarray(x), train=False))
    z16 = np.asarray(JaxSparseGAT(**kw, precision="bf16").apply(
        variables, gj, jnp.asarray(x), train=False))
    sd = {f"{name}.{k}": v for name, layer in variables["params"].items()
          for k, v in sparse_gat_layer_params_from_jax(layer).items()}
    model = SparseGAT(12, 8, 8, 2, 0.0, precision="bf16")
    model.load_state_dict(sd)
    xt = torch.from_numpy(x).requires_grad_()
    got = model(gt, xt, train=False, impl=impl)
    near(got, z32, GAT_TOL)
    np.testing.assert_allclose(_np(got), z16, rtol=0,
                               atol=GAT_TOL * np.abs(z32).max())
    (got ** 2).sum().backward()
    for name, p in [("x", xt), *model.named_parameters()]:
        assert torch.isfinite(p.grad).all(), name
    f32 = SparseGAT(12, 8, 8, 2, 0.0)
    f32.load_state_dict(sd)
    assert torch.equal(model(gt, torch.from_numpy(x), train=False,
                             impl="flash"),
                       f32(gt, torch.from_numpy(x), train=False,
                           impl="flash"))
