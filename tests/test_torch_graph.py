"""The port's graph containers and segment op against the JAX package's.

Same COO inputs (numpy, from a seed) go through ``msha_gnn_tpu.graph`` and
``msha_gnn_torch.graph``; the CSR arrays must be identical (the edge slot
order is part of the contract), and the normalisations equal to float32
rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msha_gnn_tpu.graph as jg
import msha_gnn_torch.graph as tg
from msha_gnn_torch.ops import segment_sum


def random_coo(rng, n_src, n_dst, e, empty_rows=()):
    """COO with duplicate pairs, integer counts and some empty rows."""
    src = rng.integers(0, n_src, e)
    dst = rng.integers(0, n_dst, e)
    keep = ~np.isin(src, np.asarray(empty_rows, np.int64))
    src, dst = src[keep], dst[keep]
    # duplicate a third of the edges so combine_duplicates has work
    dup = rng.integers(0, len(src), len(src) // 3)
    src = np.concatenate([src, src[dup]])
    dst = np.concatenate([dst, dst[dup]])
    w = rng.integers(1, 4, len(src)).astype(np.float32)
    return src, dst, w


def assert_same_graph(got: tg.BipartiteGraph, want: jg.BipartiteGraph,
                      exact_weight=True):
    assert (got.n_src, got.n_dst, got.num_edges) == (
        want.n_src, want.n_dst, want.num_edges)
    for name in ("senders", "receivers", "row_ptr"):
        a = getattr(got, name)
        assert a.dtype == torch.int32, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    if exact_weight:
        np.testing.assert_array_equal(got.weight.numpy(), np.asarray(want.weight))
    else:
        np.testing.assert_allclose(got.weight.numpy(), np.asarray(want.weight),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("n_src,n_dst,e,pad", [
    (203, 37, 1500, 128),   # n_src not a multiple of 128
    (60, 5, 400, 32),
    (130, 300, 900, 16),    # more columns than rows
])
def test_from_coo_matches_jax(n_src, n_dst, e, pad):
    rng = np.random.default_rng(n_src)
    src, dst, w = random_coo(rng, n_src, n_dst, e, empty_rows=(0, 5, n_src - 1))
    got = tg.BipartiteGraph.from_coo(src, dst, w, n_src=n_src, n_dst=n_dst,
                                     pad_to_multiple=pad)
    want = jg.BipartiteGraph.from_coo(src, dst, w, n_src=n_src, n_dst=n_dst,
                                      pad_to_multiple=pad)
    assert_same_graph(got, want)
    assert got.num_padded_edges % pad == 0
    np.testing.assert_array_equal(got.edge_mask.numpy(),
                                  np.asarray(want.edge_mask))
    np.testing.assert_array_equal(got.to_dense().numpy(),
                                  np.asarray(want.to_dense()))
    # the empty rows stay empty
    ptr = got.row_ptr.numpy()
    assert ptr[1] == ptr[0] == 0 and ptr[-1] == ptr[-2]


def test_from_coo_without_combining_and_from_dense(rng):
    src, dst, w = random_coo(rng, 50, 9, 300)
    kw = dict(n_src=50, n_dst=9, pad_to_multiple=16, combine_duplicates=False)
    assert_same_graph(tg.BipartiteGraph.from_coo(src, dst, w, **kw),
                      jg.BipartiteGraph.from_coo(src, dst, w, **kw))
    dense = (rng.random((23, 7)) < 0.3) * rng.integers(1, 5, (23, 7))
    assert_same_graph(tg.BipartiteGraph.from_dense(dense, pad_to_multiple=16),
                      jg.BipartiteGraph.from_dense(dense, pad_to_multiple=16))


def test_empty_graph():
    got = tg.BipartiteGraph.from_coo([], [], [], n_src=10, n_dst=3)
    want = jg.BipartiteGraph.from_coo([], [], [], n_src=10, n_dst=3)
    assert_same_graph(got, want)
    assert got.num_padded_edges == 128 and not bool(got.edge_mask.any())


def test_transpose_matches_jax(rng):
    src, dst, w = random_coo(rng, 77, 19, 600, empty_rows=(3,))
    got = tg.BipartiteGraph.from_coo(src, dst, w, n_src=77, n_dst=19,
                                     pad_to_multiple=32).transpose(
                                         pad_to_multiple=32)
    want = jg.BipartiteGraph.from_coo(src, dst, w, n_src=77, n_dst=19,
                                      pad_to_multiple=32).transpose(
                                          pad_to_multiple=32)
    assert_same_graph(got, want)


@pytest.mark.parametrize("norm", ["normalize_by_dst_degree", "normalize_rows"])
def test_normalisations_match_jax(rng, norm):
    # column 4 and row 7 have no edges: their weights must stay 0, not nan
    src, dst, w = random_coo(rng, 90, 11, 700, empty_rows=(7,))
    keep = dst != 4
    src, dst, w = src[keep], dst[keep], w[keep]
    gt = tg.BipartiteGraph.from_coo(src, dst, w, n_src=90, n_dst=11,
                                    pad_to_multiple=64)
    gj = jg.BipartiteGraph.from_coo(src, dst, w, n_src=90, n_dst=11,
                                    pad_to_multiple=64)
    got, want = getattr(tg, norm)(gt), getattr(jg, norm)(gj)
    assert_same_graph(got, want, exact_weight=False)
    assert bool(torch.isfinite(got.weight).all())
    np.testing.assert_allclose(tg.dst_degrees(gt).numpy(),
                               np.asarray(jg.dst_degrees(gj)), rtol=1e-6)
    np.testing.assert_allclose(tg.src_degrees(gt).numpy(),
                               np.asarray(jg.src_degrees(gj)), rtol=1e-6)


def test_grouping_matches_jax(rng):
    ids = rng.integers(0, 6, 40)
    got, want = tg.Grouping.from_ids(ids), jg.Grouping.from_ids(ids)
    assert got.num_groups == want.num_groups and got.num_nodes == 40
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_array_equal(got.member_sizes().numpy(),
                                  np.asarray(want.member_sizes()))
    np.testing.assert_array_equal(got.to_dense().numpy(),
                                  np.asarray(want.to_dense()))


def test_segment_sum_drops_out_of_range_ids(rng):
    data = rng.standard_normal((50, 3)).astype(np.float32)
    ids = rng.integers(0, 9, 50).astype(np.int32)  # 8 = pad id, dropped
    got = segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 8)
    want = jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids),
                               num_segments=9)[:8]
    assert got.shape == (8, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_synthetic_flow_matches_jax_builder():
    import __graft_entry__

    from msha_gnn_torch.data import synthetic_flow

    args = dict(n=500, m=32, n_city=20, n_prov=32, records=3000, seed=3)
    got = synthetic_flow(**args)
    want = __graft_entry__._make_synthetic_flow(**args)
    assert_same_graph(got.inter, want.inter)
    for name in ("gdp", "edge_src", "edge_dst"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(got.city.group_id.numpy(),
                                  np.asarray(want.city.group_id))
    np.testing.assert_array_equal(got.province.group_id.numpy(),
                                  np.asarray(want.province.group_id))
