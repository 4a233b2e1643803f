"""The port's samplers (``msha_gnn_torch/data/sampler.py``) against the
JAX package's (``msha_gnn_tpu/data/sampler.py``): from one numpy
generator state both give the same arrays, bit for bit, over seeds,
fanouts, ``rw_step`` and ``hops`` drawn by hypothesis (a fixed seed, no
example database).  The graphs have rows with no edges, and some fanouts
exceed every degree."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from msha_gnn_torch.data import sampler
from msha_gnn_torch.graph import BipartiteGraph
from msha_gnn_tpu.data import sampler as jax_sampler
from msha_gnn_tpu.graph import BipartiteGraph as JaxBipartiteGraph

SETTINGS = dict(max_examples=12, deadline=None, database=None,
                derandomize=True)


def graphs(seed, n_src=40, n_dst=15, density=0.15):
    """The same random weighted graph in both packages: rows 0, 7 and the
    last have no edges."""
    rng = np.random.default_rng(seed)
    dense = ((rng.random((n_src, n_dst)) < density)
             * rng.integers(1, 5, (n_src, n_dst))).astype(np.float32)
    dense[[0, 7, n_src - 1]] = 0.0
    return (BipartiteGraph.from_dense(dense, pad_to_multiple=32),
            JaxBipartiteGraph.from_dense(dense, pad_to_multiple=32))


def assert_same(got, want):
    for g, w in zip(got, want):
        if isinstance(g, (bool, np.bool_)):
            assert g == w
            continue
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))


@settings(**SETTINGS)
@given(seed=st.integers(0, 2**31 - 1), rw_step=st.integers(1, 5))
def test_nearby_and_negatives_match_jax(seed, rw_step):
    g, gj = graphs(seed % 97)
    anchors = np.random.default_rng(seed).integers(0, g.n_src, 30)
    rng, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
    assert_same([sampler.sample_negatives(rng, 17, g.n_dst, rw_step)],
                [jax_sampler.sample_negatives(rng_j, 17, g.n_dst, rw_step)])
    assert_same(sampler.sample_positives_nearby(rng, g, anchors, rw_step),
                jax_sampler.sample_positives_nearby(rng_j, gj, anchors,
                                                    rw_step))
    # the generators were advanced alike
    assert rng.random() == rng_j.random()


@settings(**SETTINGS)
@given(seed=st.integers(0, 2**31 - 1), hops=st.integers(1, 4),
       rw_step=st.integers(1, 4), wide=st.booleans())
def test_random_walks_match_jax(seed, hops, rw_step, wide):
    """Walks die only at an anchor with no edges.  The JAX function then
    reads the anchor's id on the recipient side, so it runs only where
    that id is in range: anchors with edges on the 40 x 15 graph, any
    anchor on a 12 x 20 one (``wide``)."""
    g, gj = graphs(seed % 89, *((12, 20, 0.2) if wide else ()))
    rev, rev_j = g.transpose(), gj.transpose()
    pool = np.arange(g.n_src) if wide else np.flatnonzero(
        np.diff(g.row_ptr.numpy()))
    anchors = np.random.default_rng(seed + 1).choice(pool, 25)
    rng, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
    got = sampler.sample_positives_rw(rng, g, rev, anchors, hops, rw_step)
    want = jax_sampler.sample_positives_rw(rng_j, gj, rev_j, anchors, hops,
                                           rw_step)
    assert_same(got, want)
    assert got[2] == (hops % 2 == 0)
    assert rng.random() == rng_j.random()


@settings(**SETTINGS)
@given(seed=st.integers(0, 2**31 - 1), fanout=st.integers(1, 20),
       pad=st.sampled_from([16, 128, 512]))
def test_neighbor_sample_subgraph_matches_jax(seed, fanout, pad):
    """The subgraph's arrays, edge count and padding; fanout 20 exceeds
    every degree (at most 15), which keeps each row whole."""
    g, gj = graphs(seed % 83)
    seeds = np.random.default_rng(seed).permutation(g.n_src)[:30]
    rng, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
    got = sampler.neighbor_sample_subgraph(rng, g, seeds, fanout,
                                           pad_to_multiple=pad)
    want = jax_sampler.neighbor_sample_subgraph(rng_j, gj, seeds, fanout,
                                                pad_to_multiple=pad)
    for name in ("senders", "receivers", "weight", "row_ptr"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    assert (got.num_edges, got.n_src, got.n_dst) == \
        (want.num_edges, want.n_src, want.n_dst)
    assert rng.random() == rng_j.random()
    deg = np.diff(got.row_ptr.numpy())
    full = np.diff(g.row_ptr.numpy())
    assert (deg <= np.minimum(full, fanout)).all()
    in_seeds = np.isin(np.arange(g.n_src), seeds)
    np.testing.assert_array_equal(deg[in_seeds],
                                  np.minimum(full, fanout)[in_seeds])
    assert not deg[~in_seeds].any()


def test_random_walks_drop_anchors_without_edges():
    """Where the JAX function raises (an anchor with no edges whose id is
    past the recipient side's rows), the port drops the anchor's walks and
    the others follow the same draws."""
    g, _ = graphs(11)
    empty = np.array([7, g.n_src - 1])   # ids past the 15 recipients
    live = np.flatnonzero(np.diff(g.row_ptr.numpy()))[:6]
    anchors = np.concatenate([live[:3], empty, live[3:]])
    a, p, on_src = sampler.sample_positives_rw(
        np.random.default_rng(2), g, g.transpose(), anchors, 3, 2)
    assert not on_src and not np.isin(a, empty).any()
    assert len(a) == 2 * len(live) and (p < g.n_dst).all()


def test_subgraph_of_rows_without_edges_is_empty():
    g, gj = graphs(3)
    seeds = np.array([0, 7, g.n_src - 1])
    got = sampler.neighbor_sample_subgraph(np.random.default_rng(0), g,
                                           seeds, 4, pad_to_multiple=64)
    want = jax_sampler.neighbor_sample_subgraph(np.random.default_rng(0), gj,
                                                seeds, 4, pad_to_multiple=64)
    assert got.num_edges == want.num_edges == 0
    assert got.num_padded_edges == want.num_padded_edges
    np.testing.assert_array_equal(got.senders.numpy(),
                                  np.asarray(want.senders))


def test_samplers_read_a_host_graph_only():
    g, _ = graphs(5)
    on_meta = g.to("meta")
    with pytest.raises(ValueError, match="on the CPU"):
        sampler.neighbor_sample_subgraph(np.random.default_rng(0), on_meta,
                                         np.arange(4), 2)
    sub = sampler.neighbor_sample_subgraph(np.random.default_rng(0), g,
                                           np.arange(g.n_src), 2)
    assert sub.device == torch.device("cpu")
