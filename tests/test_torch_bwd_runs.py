"""The per-edge walk of ``r1_bwd_f32`` and ``csr_sddmm_f32``
(``msha_gnn_torch/csrc/gat_bwd.cuh``, shared with ``flash_bwd_f32``),
mirrored step by step in plain PyTorch by
``rank1_gat_generic_bwd_runs_plain`` and ``csr_sddmm_runs_plain``, against
the plain versions and the JAX package's operators in interpret mode.

The CSR row pointers are drawn by hypothesis (``pointers`` of
``tests/test_torch_fwd_runs.py``: empty rows at the start, in the middle
and at the end, a row across several runs, pad slots past ``ptr[n_rows]``,
graphs with no edges at all).  Each mirror must write every slot of
``[0, n_out)`` exactly once, the pads as 0, and ``r1_bwd_f32``'s mirror
every row of ``dc`` exactly once, an empty row as 0.  Tolerances against
the plain versions: ``att`` at rtol 1e-5 (one exp, the same order);
``dpre`` and ``dc`` (a difference of two d-term dots, and its sum over a
row taken by pieces in another order) at rtol 1e-4, atol 1e-5 of the
largest value; the SDDMM at rtol 1e-6 (the same dot).  Against the JAX
operators, their package's own tolerances: the generic operator's
gradients at rtol 2e-3, atol 1e-4 (``tests/test_torch_rank1_generic.py``),
the SDDMM at rtol 1e-4, atol 1e-5 on non-negative inputs
(``tests/test_torch_sddmm.py``).  The kernels themselves are held against
the plain versions and the mirrors on the card
(``tests/test_torch_cuda_kernels.py``).
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
from msha_gnn_tpu.ops.pallas import Rank1GatOperator as JaxRank1
from msha_gnn_tpu.ops.pallas import SddmmOperator as JaxSddmm
from msha_gnn_torch.ops.cuda import flash_gat as fg
from msha_gnn_torch.ops.cuda import rank1_gat as r1
from msha_gnn_torch.ops.cuda import sddmm as sd
from tests.test_torch_fwd_runs import N_COLS, csr, pointers
from tests.test_torch_rank1_gat import dense_graph

D = 8
SLOPE = 0.2


def sums_close(got, want):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-5 * max(scale, 1.0))


def generic_inputs(lengths, pad, seed, d=D, scale=1.0, dead=()):
    """CSR arrays (``col`` padded by ``pad`` slots), c, t, x, gout and the
    plain forward's out and lse, with the rows ``dead`` given lse = NEG
    (no live softmax)."""
    rng = np.random.default_rng(seed)
    ptr, col = csr(lengths, pad, rng)
    n_rows, e = len(lengths), int(ptr[-1])
    c, t = (torch.from_numpy((rng.standard_normal(k) * scale)
                             .astype(np.float32)) for k in (n_rows, N_COLS))
    x = torch.from_numpy(rng.standard_normal((N_COLS, d)).astype(np.float32))
    gout = torch.from_numpy(rng.standard_normal((n_rows, d))
                            .astype(np.float32))
    out, lse = r1.rank1_gat_generic_plain(ptr, col[:e], c, t, x, SLOPE,
                                          n_rows)
    lse[list(dead)] = r1.NEG
    return ptr, col, c, t, x, gout, out, lse


def check_generic(lengths, pad, seed, run, group, d=D, scale=1.0, dead=()):
    ptr, col, *rest = generic_inputs(lengths, pad, seed, d, scale, dead)
    n_rows, e = len(lengths), int(ptr[-1])
    att, dpre, dc, writes, dc_writes = fg.rank1_gat_generic_bwd_runs_plain(
        ptr, col, *rest, SLOPE, n_rows, run, group)
    assert bool((writes == 1).all()), f"slots written {writes.tolist()}"
    assert bool((dc_writes == 1).all()), f"dc written {dc_writes.tolist()}"
    for v in (att, dpre, dc):
        assert not v.isnan().any()
    assert not att[e:].any() and not dpre[e:].any()
    want_att, want_dpre, want_dc = r1.rank1_gat_generic_bwd_plain(
        ptr, col[:e], *rest, SLOPE, n_rows)
    np.testing.assert_allclose(att[:e].numpy(), want_att.numpy(), rtol=1e-5,
                               atol=1e-7)
    sums_close(dpre[:e], want_dpre)
    sums_close(dc, want_dc)
    empty = torch.tensor(lengths) == 0
    assert not dc[empty].any()
    for r in dead:
        assert dc[r] == 0 and not dpre[int(ptr[r]):int(ptr[r + 1])].any()
    return ptr


@pytest.mark.parametrize("group", [2, 4])
@pytest.mark.parametrize("run", [32, 128])
def test_generic_backward_walk_matches_plain(run, group):
    @settings(max_examples=6, deadline=None, database=None,
              derandomize=True)
    @given(case=pointers(run), seed=st.integers(0, 2**16))
    def check(case, seed):
        check_generic(*case, seed, run, group)

    check()


@pytest.mark.parametrize("group", [2, 4, 16])
def test_generic_backward_walk_corners(group):
    """No edges at all (with and without pads); every row empty but the
    last; a single slot; a row covering whole runs (only head pieces
    after its tail); a row beginning on a run's first slot after empty
    rows; empty rows between runs and after the last edge; c and t x30; d
    0 (att formed, dpre and dc 0) and d 129."""
    cases = (([0, 0, 0], 0, 4), ([0, 0, 0], 9, 4), ([0, 0, 5], 0, 2),
             ([1], 0, 1), ([0, 7, 0], 3, 7), ([3, 0, 0, 3], 0, 3),
             ([2, 40, 0, 1], 5, 8), ([4, 0, 0, 12, 0], 2, 4),
             ([1, 30, 0, 0], 0, 4))
    for lengths, pad, run in cases:
        check_generic(lengths, pad, 0, run, group)
    check_generic([5, 0, 70, 3], 20, 1, 16, group, scale=30.0)
    ptr = check_generic([5, 0, 70, 3], 20, 2, 16, group, d=0)
    _, col, c, t, x, gout, out, lse = generic_inputs([5, 0, 70, 3], 20, 2,
                                                     d=0)
    att, dpre, dc, _, _ = fg.rank1_gat_generic_bwd_runs_plain(
        ptr, col, c, t, x, gout, out, lse, SLOPE, 4, 16, group)
    assert bool((att[:78] > 0).all()) and not dpre.any() and not dc.any()
    check_generic([5, 0, 70, 3], 20, 3, 16, group, d=129)


def test_generic_backward_walk_rows_without_live_softmax():
    """Rows whose lse is NEG (no live edge) get att, dpre and dc 0, without
    NaN, whether they lie inside a run or cross runs."""
    for run in (4, 32):
        check_generic([5, 0, 70, 3, 9], 11, 4, run, 4, dead=(2, 4))
        check_generic([5, 0, 70, 3, 9], 11, 5, run, 8, dead=(0,))


def test_edge_walk_pieces():
    """The schedule itself on one pointer: where each row piece goes."""
    ptr = torch.tensor([0, 0, 3, 12, 12, 16], dtype=torch.int32)
    events = list(r1._edge_walk(ptr, 20, 4, 32, D))
    pieces = [ev[1:] for ev in events if ev[0] == "piece"]
    # row 1 [0, 3) inside run 0; row 2 [3, 12): tail of run 0, head of runs
    # 1 and 2; row 4 [12, 16) is run 3 whole
    assert pieces == [(0, 1, "out"), (0, 2, "tail"), (1, 2, "head"),
                      (2, 2, "head"), (3, 4, "out")]
    empties = [ev[1] for ev in events if ev[0] == "empty"]
    assert empties == [0, 3]     # row 3 by run 3, where ptr[3] = 12 begins
    pads = torch.cat([ev[1] for ev in events if ev[0] == "pads"])
    assert pads.tolist() == [16, 17, 18, 19]


def test_generic_backward_walk_matches_jax_vjp():
    """The mirror's att, dpre and dc, reduced as the operator reduces them
    (dx the att-weighted transposed sum of gout, dt the column sums of
    dpre), against the generic ``Rank1GatOperator.build(...,
    interpret=True)``'s VJP on a 150 x 70 graph (n_src not a multiple of
    128, an empty row, pad edges)."""
    gt, gj = dense_graph(31, 150, 70, 0.08, empty_rows=(7,))
    rng = np.random.default_rng(3)
    c, t, x, ct = (rng.standard_normal(s).astype(np.float32)
                   for s in ((150,), (70,), (70, 16), (150, 16)))
    jop = JaxRank1.build(gj, interpret=True)
    _, vjp = jax.vjp(jop, jnp.asarray(c), jnp.asarray(t), jnp.asarray(x))
    want = [np.asarray(w) for w in vjp(jnp.asarray(ct))]
    ptr = gt.row_ptr.to(torch.int32)
    col = gt.receivers.to(torch.int32)
    e = gt.num_edges
    tc, tt, tx, tct = (torch.from_numpy(v) for v in (c, t, x, ct))
    out, lse = r1.rank1_gat_generic_plain(ptr, col[:e], tc, tt, tx, SLOPE,
                                          150)
    rows = fg.edge_rows(ptr, e)
    for run, group in ((32, 4), (128, 2)):
        att, dpre, dc, writes, dc_writes = \
            fg.rank1_gat_generic_bwd_runs_plain(ptr, col, tc, tt, tx, tct,
                                                out, lse, SLOPE, 150, run,
                                                group)
        assert bool((writes == 1).all()) and bool((dc_writes == 1).all())
        j = col[:e].long()
        dt = torch.zeros(70).index_add_(0, j, dpre[:e])
        dx = torch.zeros(70, 16).index_add_(0, j,
                                            att[:e, None] * tct[rows])
        for name, got, w in zip(("dc", "dt", "dx"), (dc, dt, dx), want):
            np.testing.assert_allclose(got.numpy(), w, rtol=2e-3, atol=1e-4,
                                       err_msg=name)
        assert dc[7] == 0


@pytest.mark.parametrize("group", [2, 4])
@pytest.mark.parametrize("run", [32, 128])
def test_sddmm_walk_matches_plain(run, group):
    @settings(max_examples=6, deadline=None, database=None,
              derandomize=True)
    @given(case=pointers(run), seed=st.integers(0, 2**16),
           d=st.sampled_from([1, 2, 16, 129]))
    def check(case, seed, d):
        lengths, pad = case
        rng = np.random.default_rng(seed)
        ptr, col = csr(lengths, pad, rng)
        e, n_out = int(ptr[-1]), int(ptr[-1]) + pad
        a = torch.from_numpy(rng.standard_normal((len(lengths), d))
                             .astype(np.float32))
        b = torch.from_numpy(rng.standard_normal((N_COLS, d))
                             .astype(np.float32))
        got, writes = sd.csr_sddmm_runs_plain(ptr, col, a, b, n_out, run,
                                              group)
        assert bool((writes == 1).all()), f"slots written {writes.tolist()}"
        want = sd.csr_sddmm_plain(ptr, col[:e], a, b, n_out)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
        assert not got[e:].any()

    check()


@pytest.fixture(scope="module")
def sddmm_graphs():
    from tests.test_torch_spmm import skewed_coo

    src, dst, w = skewed_coo(4, n_src=260, n_dst=130, e=2200)
    kw = dict(n_src=260, n_dst=130, pad_to_multiple=128)
    return (tg.BipartiteGraph.from_coo(src, dst, w, **kw),
            jg.BipartiteGraph.from_coo(src, dst, w, **kw))


@pytest.mark.parametrize("d", [1, 2, 16, 129])
def test_sddmm_walk_matches_jax_operator(sddmm_graphs, d):
    """The mirror against ``SddmmOperator.build(..., interpret=True)`` (the
    Pallas ``_sddmm_kernel`` / ``_sddmm_hub_kernel``) on a skewed 260 x
    130 graph, n_src not a multiple of 128, pads 0."""
    gt, gj = sddmm_graphs
    rng = np.random.default_rng(d + 40)
    h_src = rng.random((gt.n_src, d)).astype(np.float32)
    h_dst = rng.random((gt.n_dst, d)).astype(np.float32)
    want = np.asarray(JaxSddmm.build(gj, interpret=True)(
        jnp.asarray(h_src), jnp.asarray(h_dst)))
    op = sd.SddmmOperator(gt)
    for run, group in ((32, 4), (128, 2)):
        got, writes = sd.csr_sddmm_runs_plain(
            op.spmm.ptr, op.spmm.col, torch.from_numpy(h_src),
            torch.from_numpy(h_dst), gt.num_padded_edges, run, group)
        assert bool((writes == 1).all())
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
        assert not got[gt.num_edges:].any()
