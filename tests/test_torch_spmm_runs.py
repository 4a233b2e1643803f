"""The edge-run schedule of ``csr_spmm_f32`` and ``seg_reduce_f32``
(``msha_gnn_torch/csrc/runs.cuh``), mirrored step by step in plain PyTorch
by ``csr_spmm_runs_plain``, against the plain SpMM, the plain sorted
segment sum and the JAX package's ``spmm``.

The CSR row pointers are drawn by hypothesis (fixed seed, no example
database): empty rows anywhere (first, last, runs of them, every row),
and one row longer than ten runs; with the fix-up's chunks cut small
(``FIXES``), also rows that cross chunks (``chunk_rows`` of
``tests/test_torch_fwd_runs.py``).  The mirror must write every output row
exactly once, and hold the sums at the card tests' tolerance for sums:
rtol 1e-4, atol 1e-5 of the largest value (float32 sums of up to 3,000
terms, added by pieces in another order).  The kernels themselves are held against the
mirror's function on the card (``tests/test_torch_cuda_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import msha_gnn_tpu.graph as jg
from msha_gnn_tpu.ops import spmm as jax_spmm
from msha_gnn_torch.ops.cuda import spmm as cuda_spmm
from tests.test_torch_fwd_runs import chunk_rows

RTOL = 1e-4
# (workers, runs a worker) of the fix-up's first level, cut small so that
# the tests' rows cross chunks
FIXES = [(1, 3), (2, 2), (4, 1)]


def sums_close(got, want):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=1e-5 * max(scale, 1.0))
N_COLS = 9


@st.composite
def row_lengths(draw, run, chunk=None):
    """Row lengths with empty rows and one row longer than ten runs; given
    ``chunk`` (slots a fix-up chunk), also the rows of ``chunk_rows``: one
    spanning several chunks, one from inside a chunk to inside the next,
    several segments in a chunk, one ending on a chunk boundary."""
    lengths = draw(st.lists(st.one_of(st.just(0), st.integers(1, 40)),
                            min_size=1, max_size=25))
    if draw(st.booleans()):
        at = draw(st.integers(0, len(lengths) - 1))
        lengths[at] = 10 * run + draw(st.integers(1, 2 * run))
    if chunk is not None:
        lengths += draw(chunk_rows(run, chunk, sum(lengths)))
    return lengths


def csr(lengths, seed):
    rng = np.random.default_rng(seed)
    ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    col = rng.integers(0, N_COLS, int(ptr[-1])).astype(np.int32)
    w = rng.random(int(ptr[-1])).astype(np.float32) + 0.5
    return torch.from_numpy(ptr), torch.from_numpy(col), torch.from_numpy(w)


def check_once(writes):
    assert bool((writes == 1).all()), f"rows written {writes.tolist()}"


@pytest.mark.parametrize("d", [0, 1, 8, 64])
@pytest.mark.parametrize("run", [1, 32, 256])
def test_schedule_matches_plain_and_jax(run, d):
    @settings(max_examples=6, deadline=None, database=None,
              derandomize=True)
    @given(lengths=row_lengths(run), seed=st.integers(0, 2**16),
           weighted=st.booleans())
    def check(lengths, seed, weighted):
        ptr, col, w = csr(lengths, seed)
        n_rows = len(lengths)
        rng = np.random.default_rng(seed + 1)
        x = torch.from_numpy(rng.standard_normal((N_COLS, d))
                             .astype(np.float32))
        ww = w if weighted else None
        got, writes = cuda_spmm.csr_spmm_runs_plain(ptr, col, ww, x, n_rows,
                                                    run)
        check_once(writes)
        want = cuda_spmm.csr_spmm_plain(ptr, col, ww, x, n_rows)
        sums_close(got, want)
        # the JAX package's spmm on the same matrix
        gj = jg.BipartiteGraph.from_coo(
            np.repeat(np.arange(n_rows), lengths), col.numpy(),
            w.numpy() if weighted else np.ones(col.numel(), np.float32),
            n_src=n_rows, n_dst=N_COLS, pad_to_multiple=8)
        jx = np.asarray(jax_spmm(gj, jnp.asarray(x.numpy())))
        sums_close(got, jx)

    check()


@pytest.mark.parametrize("run", [1, 32, 256])
def test_identity_schedule_is_the_sorted_segment_sum(run):
    """``col`` None (``seg_reduce_f32``): each slot's own row of values."""
    @settings(max_examples=6, deadline=None, database=None,
              derandomize=True)
    @given(lengths=row_lengths(run), seed=st.integers(0, 2**16))
    def check(lengths, seed):
        ptr, _, _ = csr(lengths, seed)
        n_rows, e = len(lengths), int(ptr[-1])
        rng = np.random.default_rng(seed + 2)
        values = torch.from_numpy(rng.standard_normal((e + 16, 8))
                                  .astype(np.float32))
        values[e:] = float("nan")      # pads past ptr[-1] are not read
        senders = torch.repeat_interleave(torch.arange(n_rows),
                                          torch.tensor(lengths))
        senders = torch.cat([senders, torch.full((16,), n_rows)])
        got, writes = cuda_spmm.csr_spmm_runs_plain(ptr, None, None, values,
                                                    n_rows, run)
        check_once(writes)
        want = cuda_spmm.segment_reduce_sorted_plain(values, senders, ptr,
                                                     n_src=n_rows)
        sums_close(got, want)

    check()


def test_schedule_corners():
    """No edges at all, every row empty but the last, a single slot."""
    x = torch.ones(N_COLS, 3)
    for lengths, run in (([0, 0, 0], 4), ([0, 0, 5], 2), ([1], 1),
                         ([0, 7, 0], 7), ([3, 0, 0, 3], 3)):
        ptr, col, w = csr(lengths, 0)
        got, writes = cuda_spmm.csr_spmm_runs_plain(ptr, col, w, x,
                                                    len(lengths), run)
        check_once(writes)
        torch.testing.assert_close(
            got, cuda_spmm.csr_spmm_plain(ptr, col, w, x, len(lengths)))


def test_run_lengths():
    """Runs fill the card's warps at the path's shapes; d = 1 takes a
    thread per run."""
    assert cuda_spmm.warp_run(328012) == 128     # the linkpred graph
    assert cuda_spmm.warp_run(101374) == 32      # the GCN graph
    assert cuda_spmm.warp_run(10**8) == 256
    assert cuda_spmm.run_for(328012, 64) == 128
    assert cuda_spmm.run_for(328012, 1) == cuda_spmm.RUN_D1
    assert cuda_spmm.n_runs(0, 32) == 1
    assert cuda_spmm.n_runs(65, 32) == 3


def check_spans(spans, ptr, run, fix):
    """The mirror's own count of the rows it added at level 2 is the
    pointer's, by ``crossing_spans``."""
    want = cuda_spmm.crossing_spans(ptr.numpy(), run, fix[0] * fix[1])
    assert (spans["long_crossings"], spans["longest_crossing_runs"]) == want


@pytest.mark.parametrize("d", [1, 8])
@pytest.mark.parametrize("fix", FIXES, ids=lambda f: f"fix{f[0]}x{f[1]}")
@pytest.mark.parametrize("run", [1, 4])
def test_schedule_across_chunks(run, fix, d):
    """Rows that cross the fix-up's chunks, added by its two levels."""
    @settings(max_examples=6, deadline=None, database=None,
              derandomize=True)
    @given(lengths=row_lengths(run, chunk=fix[0] * fix[1] * run),
           seed=st.integers(0, 2**16), weighted=st.booleans())
    def check(lengths, seed, weighted):
        ptr, col, w = csr(lengths, seed)
        n_rows = len(lengths)
        rng = np.random.default_rng(seed + 1)
        x = torch.from_numpy(rng.standard_normal((N_COLS, d))
                             .astype(np.float32))
        ww = w if weighted else None
        spans = {}
        got, writes = cuda_spmm.csr_spmm_runs_plain(ptr, col, ww, x, n_rows,
                                                    run, fix, spans)
        check_once(writes)
        sums_close(got, cuda_spmm.csr_spmm_plain(ptr, col, ww, x, n_rows))
        check_spans(spans, ptr, run, fix)
        assert spans["long_crossings"] > 0

    check()


@pytest.mark.parametrize("fix", FIXES, ids=lambda f: f"fix{f[0]}x{f[1]}")
@pytest.mark.parametrize("run", [1, 4])
def test_identity_schedule_across_chunks(run, fix):
    """``seg_reduce_f32``'s schedule over rows that cross chunks."""
    @settings(max_examples=4, deadline=None, database=None,
              derandomize=True)
    @given(lengths=row_lengths(run, chunk=fix[0] * fix[1] * run),
           seed=st.integers(0, 2**16))
    def check(lengths, seed):
        ptr, _, _ = csr(lengths, seed)
        n_rows, e = len(lengths), int(ptr[-1])
        rng = np.random.default_rng(seed + 2)
        values = torch.from_numpy(rng.standard_normal((e + 4, 3))
                                  .astype(np.float32))
        values[e:] = float("nan")
        got, writes = cuda_spmm.csr_spmm_runs_plain(ptr, None, None, values,
                                                    n_rows, run, fix)
        check_once(writes)
        sums_close(got, cuda_spmm.segment_reduce_sorted_plain(
            values, None, ptr, n_src=n_rows))

    check()


# At run 2 and 2 workers of 2 runs, a chunk is 8 slots.
CHUNK_CORNERS = {
    "spans_several_chunks": [3, 30, 2],
    "inside_one_chunk_to_inside_the_next": [5, 6, 1],
    "several_segments_in_a_chunk": [1, 3, 3, 1, 4, 0, 3],
    "ends_on_a_chunk_boundary": [3, 13, 0, 8, 8, 2],
}


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("case", sorted(CHUNK_CORNERS))
def test_schedule_chunk_corners(case, d):
    """Each way a row meets the chunks, alone, written once."""
    lengths = CHUNK_CORNERS[case]
    ptr, col, w = csr(lengths, 3)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (N_COLS, d)).astype(np.float32))
    spans = {}
    got, writes = cuda_spmm.csr_spmm_runs_plain(ptr, col, w, x, len(lengths),
                                                2, (2, 2), spans)
    check_once(writes)
    sums_close(got, cuda_spmm.csr_spmm_plain(ptr, col, w, x, len(lengths)))
    check_spans(spans, ptr, 2, (2, 2))


@pytest.mark.parametrize("pointer", ["hub", "uniform"])
def test_crossing_spans_count_the_hub_rows(pointer):
    """``crossing_spans`` against the mirror's own count: a hub row longer
    than a chunk reads above 0, rows of 8 slots over runs of 4 (each
    crossing one run boundary, none a chunk's) read 0."""
    lengths = ([5, 0, 700, 9, 3, 250, 0, 4] if pointer == "hub"
               else [8] * 40)
    ptr, col, w = csr(lengths, 5)
    x = torch.ones(N_COLS, 2)
    spans = {}
    cuda_spmm.csr_spmm_runs_plain(ptr, col, w, x, len(lengths), 4, (2, 4),
                                  spans)
    check_spans(spans, ptr, 4, (2, 4))
    long, longest = cuda_spmm.crossing_spans(ptr.numpy(), 4, 8)
    if pointer == "hub":
        assert long == 2 and longest == 176
    else:
        assert long == 0 and longest == 2
