"""The edge-run forward walk of ``flash_fwd_f32`` and ``r1_fwd_f32``
(``msha_gnn_torch/csrc/gat_fwd.cuh``, shared with ``r1l_fwd_f32``),
mirrored step by step in plain PyTorch by ``flash_gat_runs_plain`` and
``rank1_gat_generic_runs_plain``, against the plain versions and the JAX
package's operators in interpret mode.

The CSR row pointers are drawn by hypothesis (fixed seed, no example
database): empty rows at the start, in the middle and at the end, a row
across several runs, pad slots past ``ptr[n_rows]`` in ``col`` and the
logits, and graphs with no edges at all.  Each mirror must write every
output row exactly once (an empty row as 0 and NEG) and hold ``out`` and
``lse`` at rtol 1e-4, atol 1e-5 of the largest value (float32 online
softmaxes merged by pieces in another order).  Against the JAX operators
the tolerances are the JAX package's forward ones, rtol 1e-4 and atol
1e-5.  The kernels themselves are held against the plain versions and the
mirrors on the card (``tests/test_torch_cuda_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import msha_gnn_tpu.graph as jg
import msha_gnn_torch.graph as tg
from msha_gnn_tpu.ops.pallas import FlashGATOperator as JaxFlash
from msha_gnn_tpu.ops.pallas import Rank1GatOperator as JaxRank1
from msha_gnn_torch.ops.cuda import flash_gat as fg
from msha_gnn_torch.ops.cuda import rank1_gat as r1

N_COLS = 9
D = 8
SLOPE = 0.2


def close(got, want, rtol=1e-4):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=1e-5 * max(scale, 1.0))


@st.composite
def chunk_rows(draw, run, chunk, at):
    """Rows that cross the sums' fix-up chunks of ``chunk`` slots
    (``csrc/runs.cuh``), placed after ``at`` slots in a drawn order with
    empty rows between them: one spanning several chunks, one that begins
    inside a chunk and ends inside the next, three short rows that cross
    runs (several segments to a chunk), and one that ends exactly on a
    chunk boundary."""
    rows = []
    for kind in draw(st.permutations(["span", "straddle", "several",
                                      "boundary"])):
        rows += draw(st.sampled_from([[], [0]]))
        if kind == "span":
            new = [draw(st.integers(2 * chunk + 1, 4 * chunk))]
        elif kind == "several":
            new = [run + 1 + draw(st.integers(0, run)) for _ in range(3)]
        else:
            if at % chunk == 0:   # begin inside a chunk
                rows.append(1)
                at += 1
            to_edge = chunk - at % chunk
            new = [to_edge + (draw(st.integers(1, chunk - 1))
                              if kind == "straddle" else 0)]
        rows += new
        at += sum(new)
    return rows


@st.composite
def pointers(draw, run, chunk=None):
    """(row lengths, pad slots): empty rows at the start, in the middle and
    at the end, one row across several runs, or no edges at all; given
    ``chunk`` (slots a fix-up chunk), also the rows of ``chunk_rows``."""
    pad = draw(st.integers(0, 2 * run))
    if draw(st.integers(0, 7)) == 0:
        return [0] * draw(st.integers(1, 6)), pad
    body = draw(st.lists(st.one_of(st.just(0), st.integers(1, 40)),
                         min_size=1, max_size=20))
    mid = draw(st.integers(0, len(body)))
    crossing = draw(st.integers(2 * run + 1, 4 * run))
    lengths = (draw(st.sampled_from([[], [0], [0, 0]])) + body[:mid]
               + [0, crossing] + body[mid:])
    if chunk is not None:
        lengths += draw(chunk_rows(run, chunk, sum(lengths)))
    lengths += draw(st.sampled_from([[], [0], [0, 0]]))
    return lengths, pad


def csr(lengths, pad, rng):
    ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    col = rng.integers(0, N_COLS, int(ptr[-1]) + pad).astype(np.int32)
    return torch.from_numpy(ptr), torch.from_numpy(col)


def check_flash(lengths, pad, seed, rate, run, group, d=D, scale=3.0):
    rng = np.random.default_rng(seed)
    ptr, col = csr(lengths, pad, rng)
    n_rows, e = len(lengths), int(ptr[-1])
    logits = torch.from_numpy(
        (rng.standard_normal(e + pad) * scale).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((N_COLS, d)).astype(np.float32))
    dseed = torch.tensor([seed - 2**15], dtype=torch.int32)
    out, lse, writes = fg.flash_gat_runs_plain(ptr, col, logits, x, dseed,
                                               rate, n_rows, run, group)
    assert bool((writes == 1).all()), f"rows written {writes.tolist()}"
    assert not out.isnan().any() and not lse.isnan().any()
    want_out, want_lse = fg.flash_gat_plain(ptr, col[:e], logits, x, dseed,
                                            rate, n_rows)
    close(out, want_out)
    close(lse, want_lse)
    empty = torch.tensor(lengths) == 0
    assert not out[empty].any() and bool((lse[empty] == fg.NEG).all())


def check_generic(lengths, pad, seed, run, group, d=D, scale=1.0):
    rng = np.random.default_rng(seed)
    ptr, col = csr(lengths, pad, rng)
    n_rows, e = len(lengths), int(ptr[-1])
    c, t = (torch.from_numpy((rng.standard_normal(k) * scale)
                             .astype(np.float32)) for k in (n_rows, N_COLS))
    x = torch.from_numpy(rng.standard_normal((N_COLS, d)).astype(np.float32))
    out, lse, writes = r1.rank1_gat_generic_runs_plain(
        ptr, col, c, t, x, SLOPE, n_rows, run, group)
    assert bool((writes == 1).all()), f"rows written {writes.tolist()}"
    assert not out.isnan().any() and not lse.isnan().any()
    want_out, want_lse = r1.rank1_gat_generic_plain(ptr, col[:e], c, t, x,
                                                    SLOPE, n_rows)
    close(out, want_out)
    close(lse, want_lse)
    empty = torch.tensor(lengths) == 0
    assert not out[empty].any() and bool((lse[empty] == r1.NEG).all())


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("group", [2, 4])
@pytest.mark.parametrize("run", [32, 128])
def test_flash_forward_walk_matches_plain(run, group, rate):
    @settings(max_examples=6, deadline=None, database=None,
              derandomize=True)
    @given(case=pointers(run), seed=st.integers(0, 2**16))
    def check(case, seed):
        check_flash(*case, seed, rate, run, group)

    check()


@pytest.mark.parametrize("group", [2, 4])
@pytest.mark.parametrize("run", [32, 128])
def test_generic_forward_walk_matches_plain(run, group):
    @settings(max_examples=6, deadline=None, database=None,
              derandomize=True)
    @given(case=pointers(run), seed=st.integers(0, 2**16))
    def check(case, seed):
        check_generic(*case, seed, run, group)

    check()


@pytest.mark.parametrize("form", ["flash", "generic"])
@pytest.mark.parametrize("group", [2, 4, 16])
def test_forward_walk_corners(group, form):
    """No edges at all (with and without pads), every row empty but the
    last, a single slot, a row covering whole runs, the logits x30 (c, t
    x30), d 0 and d 129 (several tiles of the kernel)."""
    cases = (([0, 0, 0], 0, 4), ([0, 0, 0], 9, 4), ([0, 0, 5], 0, 2),
             ([1], 0, 1), ([0, 7, 0], 3, 7), ([3, 0, 0, 3], 0, 3),
             ([2, 40, 0, 1], 5, 8))
    for lengths, pad, run in cases:
        if form == "flash":
            check_flash(lengths, pad, 0, 0.5, run, group)
        else:
            check_generic(lengths, pad, 0, run, group)
    for seed, kw in ((1, dict(scale=30.0)), (2, dict(d=0)),
                     (3, dict(d=129))):
        if form == "flash":
            check_flash([5, 0, 70, 3], 20, seed, 0.5, 16, group, **kw)
        else:
            check_generic([5, 0, 70, 3], 20, seed, 16, group, **kw)


def test_flash_forward_row_with_every_edge_dropped():
    """A row whose edges are all dropped by the keep mask: its softmax sum
    is over the undropped p, so out is 0 and lse finite, not NaN, whether
    the row lies inside a run or crosses runs."""
    seed = torch.tensor([1234], dtype=torch.int32)
    dropped = (r1.keep_scale_plain(torch.arange(4096), seed, 0.5)
               == 0).numpy()
    start = next(i for i in range(len(dropped) - 3)
                 if dropped[i:i + 3].all())
    lengths = [start, 3, 40]    # row 1 is slots [start, start + 3)
    rng = np.random.default_rng(5)
    ptr, col = csr(lengths, 0, rng)
    logits = torch.from_numpy(rng.standard_normal(int(ptr[-1]))
                              .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((N_COLS, D)).astype(np.float32))
    for run in (2, 32):
        out, lse, writes = fg.flash_gat_runs_plain(ptr, col, logits, x, seed,
                                                   0.5, 3, run, 4)
        assert bool((writes == 1).all())
        assert not out[1].any() and bool(torch.isfinite(lse).all())
        want_out, want_lse = fg.flash_gat_plain(ptr, col, logits, x, seed,
                                                0.5, 3)
        close(out, want_out)
        close(lse, want_lse)


def test_the_walk_is_one_for_every_logit_source():
    """The same logits through the flash mirror (read) and the generic one
    (formed from c and t) give the same bits: one walk, three sources."""
    rng = np.random.default_rng(8)
    ptr, col = csr([0, 30, 0, 300, 2, 0], 7, rng)
    c, t = (torch.from_numpy(rng.standard_normal(k).astype(np.float32))
            for k in (6, N_COLS))
    x = torch.from_numpy(rng.standard_normal((N_COLS, D)).astype(np.float32))
    pre = c[fg.edge_rows(ptr, int(ptr[-1]))] + t[col[:int(ptr[-1])].long()]
    logits = torch.where(pre >= 0, pre, SLOPE * pre)
    for run, group in ((32, 4), (128, 2)):
        generic = r1.rank1_gat_generic_runs_plain(ptr, col, c, t, x, SLOPE,
                                                  6, run, group)
        flash = fg.flash_gat_runs_plain(ptr, col, logits, x, None, 0.0, 6,
                                        run, group)
        for u, v in zip(generic, flash):
            assert torch.equal(u, v)


def graphs():
    """One fixed graph as both packages build it: 300 x 120, density 0.05,
    empty rows first, middle and last, and a row of 120 edges (across
    runs), edges padded to a multiple of 16."""
    rng = np.random.default_rng(11)
    dense = ((rng.random((300, 120)) < 0.05)
             * rng.integers(1, 5, (300, 120))).astype(np.float32)
    dense[[0, 151, 299]] = 0.0
    dense[7, :] = 1.0
    return (tg.BipartiteGraph.from_dense(dense, pad_to_multiple=16),
            jg.BipartiteGraph.from_dense(dense, pad_to_multiple=16))


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_flash_forward_walk_matches_jax_operator(rate):
    """The mirror against ``FlashGATOperator.build(..., interpret=True,
    dropout_rate=rate)`` at the JAX package's forward tolerance."""
    gt, gj = graphs()
    rng = np.random.default_rng(12)
    logits = (rng.standard_normal(gt.num_padded_edges) * 3).astype(np.float32)
    x = rng.standard_normal((120, D)).astype(np.float32)
    seed = -123457 if rate else 0
    jop = JaxFlash.build(gj, interpret=True, dropout_rate=rate)
    args = (jnp.asarray(logits), jnp.asarray(x))
    want = np.asarray(jop.drop(*args, jnp.asarray([seed], jnp.int32))
                      if rate else jop(*args))
    ptr = gt.row_ptr.to(torch.int32)
    col = gt.receivers.to(torch.int32)
    for run, group in ((32, 4), (128, 2)):
        out, _, writes = fg.flash_gat_runs_plain(
            ptr, col, torch.from_numpy(logits), torch.from_numpy(x),
            torch.tensor([seed], dtype=torch.int32), rate, 300, run, group)
        assert bool((writes == 1).all())
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-4, atol=1e-5)


def test_generic_forward_walk_matches_jax_operator():
    """The mirror against the generic ``Rank1GatOperator.build(...,
    interpret=True)`` at the JAX package's forward tolerance."""
    gt, gj = graphs()
    rng = np.random.default_rng(13)
    c = rng.standard_normal(300).astype(np.float32)
    t = rng.standard_normal(120).astype(np.float32)
    x = rng.standard_normal((120, D)).astype(np.float32)
    want = np.asarray(JaxRank1.build(gj, interpret=True)(
        jnp.asarray(c), jnp.asarray(t), jnp.asarray(x)))
    ptr = gt.row_ptr.to(torch.int32)
    col = gt.receivers.to(torch.int32)
    for run, group in ((32, 4), (128, 2)):
        out, _, writes = r1.rank1_gat_generic_runs_plain(
            ptr, col, *(torch.from_numpy(v) for v in (c, t, x)), SLOPE,
            300, run, group)
        assert bool((writes == 1).all())
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-4, atol=1e-5)
