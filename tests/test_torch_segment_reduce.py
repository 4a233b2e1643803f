"""The port's ``segment_reduce_sorted`` against the JAX package's.

The JAX side runs as its own tests run it (``tests/test_pallas_spmm.py``):
``segment_reduce_sorted(..., interpret=True)``, whose Pallas kernel
``_reduce_kernel`` runs in interpret mode.  The port's function runs its
kernel's plain version (``seg_reduce_f32`` on the card) on CPU tensors.

Against JAX at its own tests' tolerance, rtol 1e-3 and atol 1e-3: the
Pallas path sums through a bf16 hi/lo split with about 2^-16 error
relative to each N(0, 1) term, which leaves up to about 2e-5 of absolute
error in a row's sum (2.1e-5 in the first case below).  The port's plain
version is also held against numpy's own sum at rtol 1e-5, atol 1e-5
(float32, another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msha_gnn_tpu.ops.pallas import segment_reduce_sorted as jax_reduce
from msha_gnn_torch.ops import segment_reduce_sorted
from msha_gnn_torch.ops.cuda import spmm as cuda_spmm

RTOL, ATOL = 1e-3, 1e-3


def sorted_segments(rng, e, d, n, choices=None):
    senders = np.sort(rng.choice(choices, e) if choices is not None
                      else rng.integers(0, n, e)).astype(np.int32)
    values = rng.standard_normal((e, d)).astype(np.float32)
    row_ptr = np.zeros(n + 1, np.int32)
    np.add.at(row_ptr[1:], senders, 1)
    return values, senders, np.cumsum(row_ptr).astype(np.int32)


CASES = {
    # tests/test_pallas_spmm.py:15
    "segment_sum": dict(e=300, d=24, n=40, choices=None),
    # tests/test_pallas_spmm.py:34: many empty rows, blocks sharing chunks
    "empty_rows_chunk_overlap": dict(
        e=2000, d=8, n=300, choices=[0, 1, 127, 128, 129, 255, 299]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_pallas(case):
    p = CASES[case]
    rng = np.random.default_rng(0)
    values, senders, row_ptr = sorted_segments(rng, p["e"], p["d"], p["n"],
                                               p["choices"])
    want = np.asarray(jax_reduce(jnp.asarray(values), jnp.asarray(senders),
                                 jnp.asarray(row_ptr), n_src=p["n"],
                                 interpret=True))
    before = cuda_spmm.seg_launches
    got = segment_reduce_sorted(torch.from_numpy(values),
                                torch.from_numpy(senders),
                                torch.from_numpy(row_ptr), n_src=p["n"])
    assert cuda_spmm.seg_launches == before  # the plain version on the CPU
    assert got.shape == (p["n"], p["d"])
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    ref = np.zeros_like(want)
    np.add.at(ref, senders, values)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    empty = np.diff(row_ptr) == 0
    assert not got.numpy()[empty].any()


def test_pads_past_the_pointer_are_not_read():
    """Rows past ``row_ptr[n]`` (pads, sender ``>= n``) hold NaN and are not
    summed; d = 0 is a shape."""
    rng = np.random.default_rng(1)
    values, senders, row_ptr = sorted_segments(rng, 500, 5, 60)
    pad = 12
    values = np.concatenate([values, np.full((pad, 5), np.nan, np.float32)])
    senders = np.concatenate([senders, np.full(pad, 60, np.int32)])
    got = segment_reduce_sorted(torch.from_numpy(values),
                                torch.from_numpy(senders),
                                torch.from_numpy(row_ptr), n_src=60)
    want = np.zeros((60, 5), np.float32)
    np.add.at(want, senders[:500], values[:500])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    empty = segment_reduce_sorted(torch.zeros(512, 0),
                                  torch.from_numpy(senders),
                                  torch.from_numpy(row_ptr), n_src=60)
    assert empty.shape == (60, 0)
    with pytest.raises(ValueError, match="shapes"):
        segment_reduce_sorted(torch.zeros(512, 5), torch.from_numpy(senders),
                              torch.from_numpy(row_ptr), n_src=61)
