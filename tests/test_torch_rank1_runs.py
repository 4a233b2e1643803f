"""The edge-run schedules of ``r1l_fwd_f32`` and ``flash_bwd_f32``
(``msha_gnn_torch/csrc/rank1_gat.cu``, ``flash_gat.cu``, ``gat_runs.cuh``),
mirrored step by step in plain PyTorch by ``rank1_gat_runs_plain`` and
``flash_gat_bwd_runs_plain``, against the plain versions and the JAX
package's rank-1 GAT operator.

The CSR row pointers are drawn by hypothesis (fixed seed, no example
database): empty rows anywhere (first, last, runs of them, every row),
and one row longer than ten runs.  The forward's mirror must write every
output row exactly once (an empty row as 0 and NEG), and hold ``out`` and
``lse`` at rtol 1e-4, atol 1e-5 of the largest value (float32 online
softmaxes merged by pieces in another order); the backward's mirror must
write every slot of ``[0, n_out)`` exactly once, the pads as 0.  The
kernels themselves are held against the plain versions and the mirrors on
the card (``tests/test_torch_cuda_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import msha_gnn_tpu.graph as jg
import msha_gnn_torch.graph as tg
from msha_gnn_tpu.ops.pallas import Rank1GatOperator as JaxRank1
from msha_gnn_torch.ops.cuda import flash_gat as fg
from msha_gnn_torch.ops.cuda import rank1_gat as r1

RTOL = 1e-4
N_COLS = 9
D = 8
SLOPE = 0.2


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=1e-5 * max(scale, 1.0))


@st.composite
def row_lengths(draw, run):
    """Row lengths with empty rows and one row longer than ten runs."""
    lengths = draw(st.lists(st.one_of(st.just(0), st.integers(1, 40)),
                            min_size=1, max_size=25))
    if draw(st.booleans()):
        at = draw(st.integers(0, len(lengths) - 1))
        lengths[at] = 10 * run + draw(st.integers(1, 2 * run))
    return lengths


def inputs(lengths, seed, d=D, pad=0, scale=1.0):
    """CSR arrays (``col`` padded by ``pad`` slots past ``ptr[-1]``) and
    the forward's inputs, from numpy."""
    rng = np.random.default_rng(seed)
    ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    col = rng.integers(0, N_COLS, int(ptr[-1]) + pad).astype(np.int32)
    c = (rng.standard_normal(len(lengths)) * scale).astype(np.float32)
    a = (rng.standard_normal(d) * 0.3 * scale).astype(np.float32)
    x = rng.standard_normal((N_COLS, d)).astype(np.float32)
    return [torch.from_numpy(v) for v in (ptr, col, c, a, x)]


def check_forward(lengths, seed, rate, run, group, d=D, pad=0, scale=1.0):
    ptr, col, c, a, x = inputs(lengths, seed, d, pad, scale)
    n_rows, e = len(lengths), int(ptr[-1])
    dseed = torch.tensor([seed - 2**15], dtype=torch.int32)
    out, lse, writes = r1.rank1_gat_runs_plain(ptr, col, c, a, x, dseed,
                                               rate, SLOPE, n_rows, run,
                                               group)
    assert bool((writes == 1).all()), f"rows written {writes.tolist()}"
    assert not out.isnan().any() and not lse.isnan().any()
    want_out, want_lse = r1.rank1_gat_plain(ptr, col[:e], c, a, x, dseed,
                                            rate, SLOPE, n_rows)
    close(out, want_out)
    close(lse, want_lse)
    empty = torch.tensor(lengths) == 0
    assert not out[empty].any() and bool((lse[empty] == r1.NEG).all())
    return out, lse


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("group", [2, 4])
@pytest.mark.parametrize("run", [32, 128])
def test_forward_schedule_matches_plain(run, group, rate):
    @settings(max_examples=6, deadline=None, database=None,
              derandomize=True)
    @given(lengths=row_lengths(run), seed=st.integers(0, 2**16))
    def check(lengths, seed):
        check_forward(lengths, seed, rate, run, group)

    check()


@pytest.mark.parametrize("group", [2, 4, 16])
def test_forward_schedule_corners(group):
    """No edges at all, every row empty but the last, a single slot, a row
    covering whole runs, a padded ``col``, the logits x30, and d 0."""
    for lengths, run in (([0, 0, 0], 4), ([0, 0, 5], 2), ([1], 1),
                         ([0, 7, 0], 7), ([3, 0, 0, 3], 3),
                         ([2, 40, 0, 1], 8)):
        check_forward(lengths, 0, 0.5, run, group)
    check_forward([5, 0, 70, 3], 1, 0.5, 16, group, pad=20)
    check_forward([5, 0, 70, 3], 2, 0.5, 16, group, scale=30.0)
    check_forward([5, 0, 70, 3], 3, 0.5, 16, group, d=0)


def test_forward_row_with_every_edge_dropped():
    """A row whose edges are all dropped by the keep mask: its softmax sum
    is over the undropped p, so out is 0 and lse finite, not NaN."""
    seed = torch.tensor([1234], dtype=torch.int32)
    keep = r1.keep_scale_plain(torch.arange(4096), seed, 0.5)
    dropped = (keep == 0).numpy()
    start = next(i for i in range(len(dropped) - 3)
                 if dropped[i:i + 3].all())
    lengths = [start, 3, 40]    # row 1 is slots [start, start + 3)
    ptr, col, c, a, x = inputs(lengths, 5)
    for run in (2, 32):
        out, lse, writes = r1.rank1_gat_runs_plain(
            ptr, col, c, a, x, seed, 0.5, SLOPE, 3, run, 4)
        assert bool((writes == 1).all())
        assert not out[1].any() and bool(torch.isfinite(lse).all())
        want_out, want_lse = r1.rank1_gat_plain(ptr, col, c, a, x, seed,
                                                0.5, SLOPE, 3)
        close(out, want_out)
        close(lse, want_lse)


def test_piece_merge_without_edges_is_nan_free():
    """The online-softmax merge of pieces with no edge (NEG, 0, 0)."""
    neg, zero = torch.tensor(r1.NEG), torch.tensor(0.0)
    acc0 = torch.zeros(3)
    m, s, acc = r1._merge(neg, zero, acc0, neg, zero, acc0)
    assert bool(m == r1.NEG) and float(s) == 0 and not acc.any()
    m, s, acc = r1._merge(neg, zero, acc0, torch.tensor(2.0),
                          torch.tensor(1.5), torch.ones(3))
    assert float(m) == 2.0 and float(s) == 1.5
    assert torch.equal(acc, torch.ones(3))


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_forward_schedule_matches_jax_operator(rate):
    """The mirror on one fixed graph against the JAX operator's forward,
    ``Rank1GatOperator.build(..., interpret=True, dst_linear=True)``, at
    the JAX package's forward tolerance (rtol 1e-4, atol 1e-5)."""
    rng = np.random.default_rng(11)
    dense = ((rng.random((300, 120)) < 0.05)
             * rng.integers(1, 5, (300, 120))).astype(np.float32)
    dense[[0, 151, 299]] = 0.0
    dense[7, :] = 1.0          # a row of 120 edges, across runs
    gt = tg.BipartiteGraph.from_dense(dense, pad_to_multiple=16)
    gj = jg.BipartiteGraph.from_dense(dense, pad_to_multiple=16)
    c = rng.standard_normal(300).astype(np.float32)
    a = (rng.standard_normal(D) * 0.3).astype(np.float32)
    x = rng.standard_normal((120, D)).astype(np.float32)
    seed = -123457 if rate else 0
    jop = JaxRank1.build(gj, interpret=True, dst_linear=True,
                         dropout_rate=rate)
    seed_j = jnp.asarray([seed], jnp.int32)
    args = (jnp.asarray(c), jnp.asarray(a), jnp.asarray(x))
    want = np.asarray(jop.drop(*args, seed_j) if rate else jop(*args))
    ptr = gt.row_ptr.to(torch.int32)
    col = gt.receivers.to(torch.int32)
    for run, group in ((32, 4), (128, 2)):
        out, _, writes = r1.rank1_gat_runs_plain(
            ptr, col, torch.from_numpy(c), torch.from_numpy(a),
            torch.from_numpy(x), torch.tensor([seed], dtype=torch.int32),
            rate, SLOPE, 300, run, group)
        assert bool((writes == 1).all())
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-4, atol=1e-5)


def check_backward(lengths, seed, run, group, pad=16, rate=0.5):
    ptr, col, _, _, x = inputs(lengths, seed)
    n_rows, e = len(lengths), int(ptr[-1])
    rng = np.random.default_rng(seed + 7)
    logits = torch.from_numpy(
        (rng.standard_normal(e + pad) * 3).astype(np.float32))
    gout = torch.from_numpy(rng.standard_normal((n_rows, D))
                            .astype(np.float32))
    dseed = torch.tensor([seed], dtype=torch.int32)
    out, lse = fg.flash_gat_plain(ptr, col[:e], logits, x, dseed, rate,
                                  n_rows)
    dl, q, writes = fg.flash_gat_bwd_runs_plain(ptr, col, logits, x, gout,
                                                out, lse, dseed, rate,
                                                n_rows, run, group)
    assert bool((writes == 1).all()), f"slots written {writes.tolist()}"
    assert not dl[e:].any() and not q[e:].any()
    want_dl, want_q = fg.flash_gat_bwd_plain(ptr, col[:e], logits, x, gout,
                                             out, lse, dseed, rate, n_rows)
    close(dl, want_dl)
    close(q, want_q, rtol=1e-5)


@pytest.mark.parametrize("group", [2, 4])
@pytest.mark.parametrize("run", [32, 128])
def test_flash_backward_walk_matches_plain(run, group):
    @settings(max_examples=6, deadline=None, database=None,
              derandomize=True)
    @given(lengths=row_lengths(run), seed=st.integers(0, 2**16),
           pad=st.integers(0, 300))
    def check(lengths, seed, pad):
        check_backward(lengths, seed, run, group, pad)

    check()


def test_flash_backward_walk_corners():
    """No edges at all (every slot a pad), runs made only of pads, a
    single slot, rate 0."""
    for lengths, run, pad in (([0, 0, 0], 4, 9), ([0, 0, 5], 2, 0),
                              ([1], 1, 3), ([0, 7, 0], 7, 20),
                              ([3, 0, 0, 3], 3, 1)):
        for group in (2, 32):
            check_backward(lengths, 0, run, group, pad)
    check_backward([5, 0, 70, 3], 1, 16, 8, 40, rate=0.0)


def test_groups_and_steps():
    """The lanes an edge and the edges a step at the path's width."""
    assert r1.group_for(64) == 8         # LinkPredConfig().hidden
    assert r1.group_for(8) == 8
    assert r1.group_for(128) == 16
    assert r1.group_for(129) == 32
    assert [r1._lane_floats(g, 64) for g in r1.GROUPS] == [8, 4, 2]
    # each group size takes 8 edges a warp a step at d 64
    assert [r1.WARP // g * r1._steps(g, 64) for g in r1.GROUPS] == [8, 8, 8]
    assert r1._lane_floats(16, 129) == 1 and r1._lane_floats(16, 6) == 1
    assert r1._lane_floats(2, 6) == 2
