"""The edge-run walk of ``csr_spmm_dw_f32`` (``msha_gnn_torch/csrc/
gat_bwd.cuh``, the source ``kDw``), mirrored step by step in plain PyTorch
by ``csr_spmm_dw_runs_plain``, against the plain version and the JAX
package's ``SpmmOperator(fused_bwd=True)`` VJP in interpret mode.

The CSR row pointers are drawn by hypothesis (``pointers`` of
``tests/test_torch_fwd_runs.py``; fixed seed, no example database): empty
rows at the start, in the middle and at the end, a row across several
runs, pad slots past ``ptr[n_rows]``, graphs with no edges at all; at
widths 0, 1, 8, 64 and 129 (above one group's tile at every group of
lanes); with the fix-up's chunks cut small, also rows that cross chunks
(``chunk_rows``).  The mirror must write every row of ``dx`` once (an empty row as
0) and every slot of ``dw`` once (the pads as 0), both with an edge map
(the ``A @ x`` direction's CSC walk, ``dw`` through ``eid``) and without.
Tolerances against the plain version: ``dw`` at rtol 1e-6, atol 1e-6 (the
same dot, in another order), ``dx`` (sums of up to 160 terms taken by
pieces in another order) at rtol 1e-4 and atol 1e-5 of its largest value.
Against the JAX operator, the tolerance of
``test_weight_gradient_matches_pallas_vjp`` (``tests/test_torch_spmm.py``):
rtol 1e-4, atol 1e-5, on non-negative inputs (the JAX kernels gather
through a bf16 hi/lo split).  The kernel itself is held against the plain
version and the mirror on the card (``tests/test_torch_cuda_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import msha_gnn_tpu.graph as jg
import msha_gnn_torch.graph as tg
from msha_gnn_tpu.ops.pallas.spmm import SpmmOperator as JaxSpmmOperator
from msha_gnn_torch.ops.cuda import spmm as cuda_spmm
from tests.test_torch_fwd_runs import N_COLS, csr, pointers
from tests.test_torch_spmm import ATOL, RTOL, skewed_coo

WIDTHS = [0, 1, 8, 64, 129]


def sums_close(got, want):
    scale = float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-5 * max(scale, 1.0))


def check_dw(lengths, pad, seed, run, group, d, mapped, fix=None):
    """The mirror at (run, group) against the plain version, every row of
    dx and slot of dw written once; ``mapped``: a shuffled edge map;
    ``fix``: the fix-up's (workers, runs a worker)."""
    rng = np.random.default_rng(seed)
    ptr, col = csr(lengths, pad, rng)
    n_rows, e = len(lengths), int(ptr[-1])
    n_dw = e + pad
    eid = (torch.from_numpy(rng.permutation(e).astype(np.int32))
           if mapped else None)
    w = torch.from_numpy(rng.standard_normal(n_dw).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((N_COLS, d)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((n_rows, d))
                         .astype(np.float32))
    dx, dw, dx_writes, dw_writes = cuda_spmm.csr_spmm_dw_runs_plain(
        ptr, col, eid, w, g, x, n_rows, n_dw, run, group, fix)
    assert bool((dx_writes == 1).all()), f"rows {dx_writes.tolist()}"
    assert bool((dw_writes == 1).all()), f"slots {dw_writes.tolist()}"
    want_dx, want_dw = cuda_spmm.csr_spmm_dw_plain(ptr, col[:e], eid, w, g,
                                                   x, n_rows, n_dw)
    torch.testing.assert_close(dw, want_dw, rtol=1e-6, atol=1e-6)
    sums_close(dx, want_dx)
    assert not dw[e:].any()
    assert not dx[torch.tensor(lengths) == 0].any()


@pytest.mark.parametrize("mapped", [False, True], ids=["csr", "eid"])
@pytest.mark.parametrize("group", [8, 32])
@pytest.mark.parametrize("run", [16, 64])
def test_dw_walk_matches_plain(run, group, mapped):
    @settings(max_examples=5, deadline=None, database=None,
              derandomize=True)
    @given(case=pointers(run), seed=st.integers(0, 2**16),
           d=st.sampled_from(WIDTHS))
    def check(case, seed, d):
        check_dw(*case, seed, run, group, d, mapped)

    check()


@pytest.mark.parametrize("fix", [(1, 3), (2, 2), (4, 1)],
                         ids=lambda f: f"fix{f[0]}x{f[1]}")
@pytest.mark.parametrize("run", [4, 16])
def test_dw_walk_across_chunks(run, fix):
    """The fix-up's chunks cut small (``fix``), on pointers with rows that
    cross them: dx's crossing rows added by both levels, each once."""
    @settings(max_examples=4, deadline=None, database=None,
              derandomize=True)
    @given(case=pointers(run, chunk=fix[0] * fix[1] * run),
           seed=st.integers(0, 2**16), d=st.sampled_from([1, 8]),
           mapped=st.booleans())
    def check(case, seed, d, mapped):
        check_dw(*case, seed, run, 8, d, mapped, fix)

    check()


@pytest.mark.parametrize("d", WIDTHS)
def test_dw_walk_corners(d):
    """No edges at all (with and without pads); every row empty but the
    last; a single slot; a row covering whole runs (only head pieces after
    its tail); a row beginning on a run's first slot after empty rows;
    empty rows between runs and after the last edge; run 1 (every slot a
    run, every row of two or more edges crossing runs)."""
    cases = (([0, 0, 0], 0, 4), ([0, 0, 0], 9, 4), ([0, 0, 5], 0, 2),
             ([1], 0, 1), ([0, 7, 0], 3, 7), ([3, 0, 0, 3], 0, 3),
             ([2, 40, 0, 1], 5, 8), ([4, 0, 0, 12, 0], 2, 4),
             ([1, 30, 0, 0], 0, 4), ([5, 0, 9, 3], 6, 1))
    for i, (lengths, pad, run) in enumerate(cases):
        check_dw(lengths, pad, i, run, 8, d, mapped=i % 2 == 1)


def test_sums_workspace_size_and_defaults():
    """The workspace of the walks that sum rows of width d: the head and
    tail partials ``[n, d]`` and ``cross`` of the runs (at least one) and
    of the fix-up's chunks (512 runs at d = 1, 64 above); the dw walk's
    default run length is one the sweep covers."""
    assert cuda_spmm.sums_ws_floats(20, 4, 64) == (5 + 1) * 129
    assert cuda_spmm.sums_ws_floats(0, 64, 8) == (1 + 1) * 17
    assert cuda_spmm.sums_ws_floats(129, 128, 0) == (2 + 1) * 1
    assert cuda_spmm.sums_ws_floats(5000, 1, 1) == (5000 + 10) * 3
    assert cuda_spmm.sums_ws_floats(65 * 32, 32, 32) == (65 + 2) * 65
    assert cuda_spmm.chunk_runs(1) == 512 and cuda_spmm.chunk_runs(64) == 64
    assert cuda_spmm.DW_RUN in cuda_spmm.RUN_SLOTS


@pytest.fixture(scope="module")
def dw_graphs():
    """A skewed 300 x 150 graph, as ``tests/test_torch_spmm.py``'s
    ``graphs``, and the JAX fused-backward operators built as its
    ``jax_bwd_ops`` builds them (interpret mode; no hub table and the
    automatic one)."""
    src, dst, w = skewed_coo(0)
    kw = dict(n_src=300, n_dst=150, pad_to_multiple=128)
    gj = jg.BipartiteGraph.from_coo(src, dst, w, **kw)
    ops = {hub: JaxSpmmOperator.build(gj, interpret=True, hub_split=hub,
                                      fused_bwd=True) for hub in (0, None)}
    return tg.BipartiteGraph.from_coo(src, dst, w, **kw), ops


@pytest.mark.parametrize("hub", [0, None], ids=["no_hub", "auto_hub"])
@pytest.mark.parametrize("transpose", [False, True])
def test_dw_walk_matches_jax_fused_vjp(dw_graphs, transpose, hub):
    """The mirror's dx and dw, walked as ``SpmmOperator.backward_dw``
    walks them (``A @ x``: the CSC with ``t_edge``; ``A.T @ x``: the CSR),
    against the JAX ``SpmmOperator(fused_bwd=True)`` VJP (its
    ``_visit_dw_kernel`` / ``_hub_dw_kernel``)."""
    gt, jax_ops = dw_graphs
    rng = np.random.default_rng(21 + 2 * transpose)
    n_in, n_out = (gt.n_src, gt.n_dst) if transpose else (gt.n_dst, gt.n_src)
    x = rng.random((n_in, 24)).astype(np.float32)
    ct = rng.random((n_out, 24)).astype(np.float32)
    ew = gt.weight.numpy() * (0.5 + rng.random(gt.num_padded_edges)
                              ).astype(np.float32)
    _, vjp = jax.vjp(lambda x, w: jax_ops[hub](x, transpose=transpose,
                                               edge_weight=w),
                     jnp.asarray(x), jnp.asarray(ew))
    want_dx, want_dw = (np.asarray(v) for v in vjp(jnp.asarray(ct)))
    op = cuda_spmm.SpmmOperator(gt, device="cpu", fused_bwd=True)
    if transpose:
        walk = (op.ptr, op.col, None, gt.n_src)
    else:
        walk = (op.t_ptr, op.t_col, op.t_edge, gt.n_dst)
    ptr, col, eid, n_rows = walk
    for run, group in ((32, 8), (128, 16)):
        dx, dw, dx_writes, dw_writes = cuda_spmm.csr_spmm_dw_runs_plain(
            ptr, col, eid, torch.from_numpy(ew), torch.from_numpy(ct),
            torch.from_numpy(x), n_rows, gt.num_padded_edges, run, group)
        assert bool((dx_writes == 1).all()) and bool((dw_writes == 1).all())
        np.testing.assert_allclose(dw.numpy(), want_dw, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(dx.numpy(), want_dx, rtol=RTOL, atol=ATOL)
        assert not dw[gt.num_edges:].any()
