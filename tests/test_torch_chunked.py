"""The port's ``ChunkedSpmm`` (``msha_gnn_torch/ops/chunked.py``) against
the JAX package's (``ops/chunked.py``, its Pallas SpMM and SDDMM in
interpret mode), on the CPU, for 1, 3 and 7 slices: the forward, the
transposed pass, ``apply``'s ``(dx, dw)`` with runtime weights,
``partition_weights`` and ``spmm_out_of_core``.  The edges come unsorted
to ``from_host_coo``, with duplicates and a hub column, so the sender sort
and the transposed operator's receiver sort both matter.

Tolerances: against a float64 computation of the same sums, rtol 1e-5,
atol 1e-6 (float32 sums in another order).  Against the JAX operator,
rtol 1e-4 and atol 1e-5 of the largest value, as the port's SpMM is held
to the JAX one (``tests/test_torch_spmm.py``): the Pallas float32 path
multiplies by a two-pass bf16 hi/lo split without the lo x lo term, about
1.5e-5 of each product (2.7e-5 absolute on sums near 5 here), which a
1e-5 bound does not take.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msha_gnn_tpu.graph as jg
import msha_gnn_torch.graph as tg
from msha_gnn_tpu.ops.chunked import ChunkedSpmm as JaxChunked
from msha_gnn_tpu.ops.chunked import spmm_out_of_core as jax_out_of_core
from msha_gnn_torch.ops.chunked import (ChunkedSpmm, slice_bounds,
                                        spmm_out_of_core)
from msha_gnn_torch.ops.cuda import sddmm as cuda_sddmm
from msha_gnn_torch.ops.cuda import spmm as cuda_spmm

RTOL, ATOL = 1e-5, 1e-6          # against float64
JAX_RTOL, JAX_ATOL = 1e-4, 1e-5  # against the JAX operator
N_SRC, N_DST, E, D = 70, 45, 900, 6


def coo(seed):
    """Unsorted COO edges with a hub receiver (0) and repeated pairs."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, N_SRC, E)
    r = np.where(rng.random(E) < 0.3, 0, rng.integers(0, N_DST, E))
    w = rng.random(E).astype(np.float32) + 0.5
    return s, r, w


def close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def like_jax(got, want, what):
    close(got, want, what, JAX_RTOL,
          JAX_ATOL * float(np.abs(np.asarray(want)).max()))


def exact_sums(s, r, w, x, xt, ew, cot):
    """float64 of ``A x``, ``A^T xt``, ``A(ew)^T xt``, ``A(ew) x`` and its
    ``(dx, dw)``; ``ew`` in CSR (stable sender) order."""
    order = np.argsort(s, kind="stable")
    s, r, w = s[order], r[order], w[order].astype(np.float64)
    ew = ew.astype(np.float64)
    x, xt, cot = (v.astype(np.float64) for v in (x, xt, cot))

    def spmm(rows, cols, ww, v, n):
        out = np.zeros((n, v.shape[1]))
        np.add.at(out, rows, ww[:, None] * v[cols])
        return out

    return (spmm(s, r, w, x, N_SRC), spmm(r, s, w, xt, N_DST),
            spmm(r, s, ew, xt, N_DST), spmm(s, r, ew, x, N_SRC),
            spmm(r, s, ew, cot, N_DST), (cot[s] * x[r]).sum(1))


@pytest.mark.parametrize("num_slices", [1, 3, 7])
def test_chunked_spmm_matches_jax(num_slices):
    s, r, w = coo(num_slices)
    kw = dict(n_src=N_SRC, n_dst=N_DST, num_slices=num_slices)
    jop = JaxChunked.from_host_coo(s, r, w, interpret=True, **kw)
    op = ChunkedSpmm.from_host_coo(s, r, w, device="cpu", **kw)
    assert len(op.slices) == num_slices
    rng = np.random.default_rng(10 + num_slices)
    x = rng.standard_normal((N_DST, D)).astype(np.float32)
    xt = rng.standard_normal((N_SRC, D)).astype(np.float32)
    ew = rng.random(E).astype(np.float32)         # CSR order
    cot = rng.standard_normal((N_SRC, D)).astype(np.float32)
    before = (cuda_spmm.launches, cuda_sddmm.launches)
    want = exact_sums(s, r, w, x, xt, ew, cot)

    got = op(torch.from_numpy(x))
    like_jax(got, jop(jnp.asarray(x)), "A x")
    close(got, want[0], "A x")
    got = op(torch.from_numpy(xt), transpose=True)
    like_jax(got, jop(jnp.asarray(xt), transpose=True), "A^T x")
    close(got, want[1], "A^T x")
    got = op(torch.from_numpy(xt), transpose=True,
             edge_weight=torch.from_numpy(ew))
    like_jax(got, jop(jnp.asarray(xt), transpose=True,
                      edge_weight=jnp.asarray(ew)), "A(w)^T x")
    close(got, want[2], "A(w)^T x")

    out_j, vjp = jax.vjp(jop.apply, jnp.asarray(x), jnp.asarray(ew))
    dx_j, dw_j = vjp(jnp.asarray(cot))
    xx = torch.from_numpy(x).requires_grad_()
    ww = torch.from_numpy(ew).requires_grad_()
    out = op.apply(xx, ww)
    out.backward(torch.from_numpy(cot))
    for what, g, j, ref in (("apply", out.detach(), out_j, want[3]),
                            ("dx", xx.grad, dx_j, want[4]),
                            ("dw", ww.grad, dw_j, want[5])):
        like_jax(g, j, what)
        close(g, ref, what)
    # each slice's weights, then zeros (the JAX layout pads every slice to
    # its schedule's chunk multiple; the port's to the longest slice)
    got = op.partition_weights(torch.from_numpy(ew)).numpy()
    want_p = np.asarray(jop.partition_weights(jnp.asarray(ew)))
    for i, (lo, hi) in enumerate(op.bounds):
        np.testing.assert_array_equal(got[i, : hi - lo],
                                      want_p[i, : hi - lo])
        assert not got[i, hi - lo:].any()
    # CPU tensors run the kernels' plain versions
    assert (cuda_spmm.launches, cuda_sddmm.launches) == before


def test_chunked_spmm_of_a_graph_and_one_shot():
    """``ChunkedSpmm(graph, k)`` and ``spmm_out_of_core`` on a padded graph
    with empty rows, against the JAX package's."""
    s, r, w = coo(5)
    kw = dict(n_src=N_SRC, n_dst=N_DST)
    gt = tg.BipartiteGraph.from_coo(s, r, w, **kw)
    gj = jg.BipartiteGraph.from_coo(s, r, w, **kw)
    x = np.random.default_rng(6).standard_normal((N_DST, D)).astype(
        np.float32)
    dense = gt.to_dense().numpy().astype(np.float64) @ x
    for k in (1, 4):
        got = spmm_out_of_core(gt, torch.from_numpy(x), num_slices=k)
        like_jax(got, jax_out_of_core(gj, jnp.asarray(x), num_slices=k,
                                      interpret=True), f"{k} slices")
        close(got, dense, f"{k} slices")
    assert ChunkedSpmm(gt, 4).device == torch.device("cpu")


def test_slices_are_balanced_contiguous_ranges():
    assert slice_bounds(10, 3) == [(0, 3), (3, 6), (6, 10)]
    assert slice_bounds(2, 4) == [(0, 0), (0, 1), (1, 1), (1, 2)]
    s, r, w = coo(7)
    op = ChunkedSpmm.from_host_coo(s, r, w, n_src=N_SRC, n_dst=N_DST,
                                   num_slices=5, device="cpu")
    for sl in op.slices:
        assert int(sl.ptr[-1]) == sl.hi - sl.lo
        assert sl.ptr.dtype == torch.int32 and sl.col.dtype == torch.int32
    # more slices than edges: the empty ones are dropped
    tiny = ChunkedSpmm.from_host_coo([3, 1], [0, 2], None, n_src=4, n_dst=3,
                                     num_slices=4, device="cpu")
    assert len(tiny.slices) == 2
    got = tiny(torch.eye(3))
    assert got.tolist() == [[0, 0, 0], [0, 0, 1], [0, 0, 0], [1, 0, 0]]
