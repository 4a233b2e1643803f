"""The port's ``ChunkedRank1Gat`` (``msha_gnn_torch/ops/chunked_rank1.py``)
against the JAX package's (``ops/chunked_rank1.py``, its Pallas kernels in
interpret mode) and a float64 computation of the same function, on the
CPU: slice invariance for 1, 3 and 7 slices, a row split across slices,
rows without edges, the gradients ``(dc, da, dx)``, and the bfloat16
payload.

Tolerances.  float32: against float64, rtol 1e-5 and atol 1e-5 of the
largest value (float32 softmaxes merged across slices and sums in another
order).  Against the JAX operator, whose float32 path multiplies by a bf16
hi/lo split without the lo x lo term (about 1.5e-5 of each product, as
``tests/test_torch_chunked.py`` says): the forward at rtol 1e-4 and atol
1e-5 of the largest value; the gradients at the JAX test's own bound for
them, rtol 2e-3 and atol 1e-3 (``tests/test_chunked_rank1.py:42-65``),
since ``dc`` of a one-edge row is an exact 0 that the JAX backward misses
by its products' error (2.5e-5 here).  bfloat16: 3e-2 of the float32
result's largest value, the JAX test's bound
(``tests/test_chunked_rank1.py:99-113``), against both the JAX bf16
operator and the float32 result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msha_gnn_tpu.graph as jg
import msha_gnn_torch.graph as tg
from msha_gnn_tpu.ops.chunked_rank1 import ChunkedRank1Gat as JaxChunked
from msha_gnn_torch.ops.chunked_rank1 import ChunkedRank1Gat
from msha_gnn_torch.ops.cuda import rank1_gat as r1
from msha_gnn_torch.ops.cuda import spmm as cuda_spmm

RTOL, ATOL_REL = 1e-5, 1e-5            # against float64
JAX_RTOL, JAX_ATOL_REL = 1e-4, 1e-5    # the JAX operator's forward
JAX_GRAD_RTOL, JAX_GRAD_ATOL = 2e-3, 1e-3   # and its gradients
BF16_TOL = 3e-2
SLOPE = 0.2


def close(got, want, what, rtol=RTOL, atol_rel=ATOL_REL):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max(),
                               err_msg=what)


def like_jax(got, want, what):
    """The forward (``what`` "out") or a gradient against the JAX
    operator's."""
    if what.endswith("out"):
        close(got, want, what, JAX_RTOL, JAX_ATOL_REL)
    else:
        np.testing.assert_allclose(got, want, rtol=JAX_GRAD_RTOL,
                                   atol=JAX_GRAD_ATOL, err_msg=what)


def random_edges(seed, n_src, n_dst, density):
    """Both packages' graph of a random 0/1..4 adjacency, its CSR COO."""
    rng = np.random.default_rng(seed)
    dense = ((rng.random((n_src, n_dst)) < density)
             * rng.integers(1, 5, (n_src, n_dst))).astype(np.float32)
    dense[[0, n_src // 2, n_src - 1]] = 0.0       # rows without edges
    s, r = np.nonzero(dense)
    return s.astype(np.int32), r.astype(np.int32)


def inputs(seed, n_src, n_dst, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n_src).astype(np.float32),
            (rng.standard_normal(d) * 0.3).astype(np.float32),
            rng.standard_normal((n_dst, d)).astype(np.float32),
            rng.standard_normal((n_src, d)).astype(np.float32))


def exact(s, r, n_src, c, a, x, cot):
    """float64 ``(out, dc, da, dx)`` of the dst-linear rank-1 GAT."""
    c, a, x, g = (v.astype(np.float64) for v in (c, a, x, cot))
    pre = c[s] + x[r] @ a
    logit = np.where(pre >= 0, pre, SLOPE * pre)
    m = np.full(n_src, -np.inf)
    np.maximum.at(m, s, logit)
    p = np.exp(logit - m[s])
    den = np.zeros(n_src)
    np.add.at(den, s, p)
    att = p / den[s]
    out = np.zeros((n_src, x.shape[1]))
    np.add.at(out, s, att[:, None] * x[r])
    dl = att * ((g[s] * x[r]).sum(1) - (g * out).sum(1)[s])
    dpre = np.where(pre >= 0, dl, SLOPE * dl)
    dc = np.zeros(n_src)
    np.add.at(dc, s, dpre)
    dx = np.zeros(x.shape)
    np.add.at(dx, r, att[:, None] * g[s] + dpre[:, None] * a[None, :])
    return out, dc, (dpre[:, None] * x[r]).sum(0), dx


def port_vjp(op, c, a, x, cot):
    ins = [torch.from_numpy(v).requires_grad_() for v in (c, a, x)]
    out = op(*ins)
    out.backward(torch.from_numpy(cot))
    return [out.detach().numpy()] + [v.grad.numpy() for v in ins]


def jax_vjp(op, c, a, x, cot):
    out, vjp = jax.vjp(op, jnp.asarray(c), jnp.asarray(a), jnp.asarray(x))
    return [np.asarray(out)] + [np.asarray(v) for v in vjp(jnp.asarray(cot))]


@pytest.mark.parametrize("num_slices", [1, 3, 7])
def test_chunked_rank1_matches_jax(num_slices):
    """Forward and ``(dc, da, dx)`` against the JAX operator and float64;
    the rows without edges give 0 and no dc; nothing is launched."""
    s, r = random_edges(num_slices, 300, 120, 0.05)
    c, a, x, cot = inputs(num_slices, 300, 120, 16)
    kw = dict(n_src=300, n_dst=120, num_slices=num_slices,
              assume_sorted=True)
    jop = JaxChunked(s, r, interpret=True, **kw)
    op = ChunkedRank1Gat(s, r, device="cpu", **kw)
    before = (r1.fwd_launches, r1.bwd_launches, cuda_spmm.launches)
    got = port_vjp(op, c, a, x, cot)
    assert (r1.fwd_launches, r1.bwd_launches, cuda_spmm.launches) == before
    for what, g, j, ref in zip(("out", "dc", "da", "dx"), got,
                               jax_vjp(jop, c, a, x, cot),
                               exact(s, r, 300, c, a, x, cot)):
        like_jax(g, j, what)
        close(g, ref, what)
    empty = [0, 150, 299]
    assert not got[0][empty].any() and not got[1][empty].any()


def test_chunked_rank1_is_slice_invariant():
    """1, 3 and 7 slices of the same unsorted edges give one function; the
    merged ``lse`` is NEG on the rows without edges."""
    s, r = random_edges(11, 200, 90, 0.06)
    perm = np.random.default_rng(0).permutation(len(s))
    c, a, x, cot = inputs(12, 200, 90, 8)
    runs = {}
    for k in (1, 3, 7):
        op = ChunkedRank1Gat(s[perm], r[perm], n_src=200, n_dst=90,
                             num_slices=k, device="cpu")
        runs[k] = port_vjp(op, c, a, x, cot)
        out, lse = op.forward_state(torch.from_numpy(c), torch.from_numpy(a),
                                    torch.from_numpy(x))
        assert bool((lse[[0, 100, 199]] == r1.NEG).all())
        assert bool((lse[s] > r1.NEG / 2).all())
    for k in (3, 7):
        for what, g, w in zip(("out", "dc", "da", "dx"), runs[k], runs[1]):
            close(g, w, f"{k} slices {what}")


def test_chunked_rank1_row_split_across_slices():
    """A hub row of 3,000 edges across several slice boundaries (the JAX
    test's graph, ``tests/test_chunked_rank1.py:68-96``): the merge of its
    pieces against the JAX operator, float64 and the port's unsliced
    ``Rank1GatOperator(dst_linear=True)``; the other rows have no edges or
    lie in one slice."""
    senders = np.concatenate([np.zeros(50, np.int64),
                              np.full(3000, 40, np.int64),
                              np.full(60, 350, np.int64)])
    receivers = (np.arange(len(senders)) * 7) % 90
    kw = dict(n_src=400, n_dst=90)
    gt = tg.BipartiteGraph.from_coo(senders, receivers,
                                    np.ones(len(senders), np.float32), **kw)
    gj = jg.BipartiteGraph.from_coo(senders, receivers,
                                    np.ones(len(senders), np.float32), **kw)
    e = gt.num_edges
    s, r = gt.senders[:e].numpy(), gt.receivers[:e].numpy()
    assert np.array_equal(s, np.asarray(gj.senders)[:e])
    rng = np.random.default_rng(3)
    c = (rng.standard_normal(400) * 2).astype(np.float32)
    a = (rng.standard_normal(8) * 0.5).astype(np.float32)
    x = rng.standard_normal((90, 8)).astype(np.float32)
    cot = rng.standard_normal((400, 8)).astype(np.float32)
    whole = port_vjp(r1.Rank1GatOperator(gt, dst_linear=True), c, a, x, cot)
    want = exact(s, r, 400, c, a, x, cot)
    for k in (2, 5):
        op = ChunkedRank1Gat(s, r, num_slices=k, assume_sorted=True,
                             device="cpu", **kw)
        assert sum(40 in rs.sl.rows.tolist() for rs in op.slices) >= 2
        got = port_vjp(op, c, a, x, cot)
        jop = JaxChunked(s, r, num_slices=k, assume_sorted=True,
                         interpret=True, **kw)
        for what, g, j, ref, w in zip(("out", "dc", "da", "dx"), got,
                                      jax_vjp(jop, c, a, x, cot), want,
                                      whole):
            like_jax(g, j, f"{k} slices {what}")
            close(g, ref, f"{k} slices {what}")
            close(g, w, f"{k} slices {what} vs unsliced")
        empty = np.setdiff1d(np.arange(400), senders)
        assert not got[0][empty].any()


def test_chunked_rank1_bf16_matches_jax():
    """``precision="bf16"``: forward and gradients against the JAX bf16
    operator and the float32 result at 3e-2 of its largest value."""
    s, r = random_edges(5, 200, 100, 0.05)
    c, a, x, cot = inputs(5, 200, 100, 16)
    kw = dict(n_src=200, n_dst=100, num_slices=3, assume_sorted=True)
    f32 = port_vjp(ChunkedRank1Gat(s, r, device="cpu", **kw), c, a, x, cot)
    before = (r1.fwd_bf16_launches, r1.bwd_bf16_launches)
    got = port_vjp(ChunkedRank1Gat(s, r, device="cpu", precision="bf16",
                                   **kw), c, a, x, cot)
    assert (r1.fwd_bf16_launches, r1.bwd_bf16_launches) == before
    jop = JaxChunked(s, r, interpret=True, precision="bf16", **kw)
    for what, g, j, ref in zip(("out", "dc", "da", "dx"), got,
                               jax_vjp(jop, c, a, x, cot), f32):
        tol = BF16_TOL * np.abs(ref).max()
        np.testing.assert_allclose(g, j, rtol=0, atol=tol, err_msg=what)
        assert np.abs(g - ref).max() <= tol, what
    assert not np.array_equal(got[0], f32[0])


def test_chunked_rank1_checks():
    s, r = random_edges(2, 30, 20, 0.2)
    with pytest.raises(ValueError, match="precision"):
        ChunkedRank1Gat(s, r, n_src=30, n_dst=20, num_slices=2,
                        precision="f16", device="cpu")
    op = ChunkedRank1Gat(s, r, n_src=30, n_dst=20, num_slices=2,
                         device="cpu")
    with pytest.raises(ValueError, match="for 30 x 20"):
        op(torch.zeros(30), torch.zeros(4), torch.zeros(19, 4))


@pytest.mark.parametrize("graph", ["hub", "uniform"])
def test_chunked_rank1_counts_the_hub_rows(graph):
    """``long_crossings`` reads the receivers whose edges in a slice span
    more runs than one fix-up chunk holds (16,384 slots at d = 1, 2,048 at
    d > 1 on these 32-slot runs), at both widths: receiver 0 of a hub
    graph in each of its 2 slices, no receiver of a uniform one."""
    rng = np.random.default_rng(11)
    e, n = 160_000, 5_000
    s = np.sort(rng.integers(0, n, e))
    r = rng.integers(0, n, e)
    if graph == "hub":
        r[rng.random(e) < 0.5] = 0
    op = ChunkedRank1Gat(s, r, n_src=n, n_dst=n, num_slices=2,
                         assume_sorted=True, device="cpu")
    spans = [[cuda_spmm.crossing_spans(rs.t_ptr.numpy(),
                                       cuda_spmm.run_for(rs.t_col.numel(), d),
                                       cuda_spmm.chunk_runs(d))
              for rs in op.slices] for d in (1, 2)]
    assert op.long_crossings == tuple(sum(v[0] for v in w) for w in spans)
    assert op.longest_crossing_runs == tuple(max(v[1] for v in w)
                                             for w in spans)
    if graph == "hub":
        assert op.long_crossings == (2, 2)
        assert min(op.longest_crossing_runs) > 512
    else:
        assert op.long_crossings == (0, 0)
        assert max(op.longest_crossing_runs) <= 2
