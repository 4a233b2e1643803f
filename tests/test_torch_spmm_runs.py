"""The edge-run schedule of ``csr_spmm_f32`` and ``seg_reduce_f32``
(``msha_gnn_torch/csrc/runs.cuh``), mirrored step by step in plain PyTorch
by ``csr_spmm_runs_plain``, against the plain SpMM, the plain sorted
segment sum and the JAX package's ``spmm``.

The CSR row pointers are drawn by hypothesis (fixed seed, no example
database): empty rows anywhere (first, last, runs of them, every row),
and one row longer than ten runs.  The mirror must write every output row
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

RTOL = 1e-4


def sums_close(got, want):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=1e-5 * max(scale, 1.0))
N_COLS = 9


@st.composite
def row_lengths(draw, run):
    """Row lengths with empty rows and one row longer than ten runs."""
    lengths = draw(st.lists(st.one_of(st.just(0), st.integers(1, 40)),
                            min_size=1, max_size=25))
    if draw(st.booleans()):
        at = draw(st.integers(0, len(lengths) - 1))
        lengths[at] = 10 * run + draw(st.integers(1, 2 * run))
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
