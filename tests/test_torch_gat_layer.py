"""The port's ``SparseGATLayer`` on a rectangular graph, and the column
softmax of ``edge_softmax(impl="cuda")``, against the JAX package.

A rectangular graph (30 sources, 12 destinations, 100 edges) tells the
rows' features from the columns': the JAX layer takes ``(graph, x_src,
x_dst)``, its logit ``a_src . h_src[i] + a_dst . h_dst[j]`` and its
aggregation over ``h_dst``.  The JAX parameters come in through
``models/convert.py``.  Tolerance 1e-5: float32, one row's softmax and a
sum of a few terms in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msha_gnn_tpu.graph as jg
import msha_gnn_torch.graph as tg
from msha_gnn_tpu.models.gat import SparseGATLayer as JaxLayer
from msha_gnn_tpu.ops import edge_softmax as jax_edge_softmax
from msha_gnn_torch.models import (SparseGATLayer,
                                   sparse_gat_layer_params_from_jax)
from msha_gnn_torch.ops import edge_softmax

TOL = 1e-5


def rect_graphs(seed=0, n_src=30, n_dst=12, n_edges=100):
    """Both packages' graph of ``n_edges`` distinct random edges, with an
    empty source row and an empty destination column."""
    rng = np.random.default_rng(seed)
    keys = rng.choice((n_src - 1) * (n_dst - 1), n_edges, replace=False)
    src, dst = keys // (n_dst - 1) + 1, keys % (n_dst - 1)   # row 0, col 11
    w = rng.integers(1, 5, n_edges).astype(np.float32)
    kw = dict(n_src=n_src, n_dst=n_dst, pad_to_multiple=16)
    return (tg.BipartiteGraph.from_coo(src, dst, w, **kw),
            jg.BipartiteGraph.from_coo(src, dst, w, **kw), rng)


def jax_layer(gj, x_src, x_dst, d_out, seed):
    layer = JaxLayer(x_src.shape[1], d_out, dropout=0.0)
    params = layer.init(jax.random.PRNGKey(seed), gj, jnp.asarray(x_src),
                        jnp.asarray(x_dst), train=False)
    out = layer.apply(params, gj, jnp.asarray(x_src), jnp.asarray(x_dst),
                      train=False)
    return params, np.asarray(out)


def port_layer(params, d_in, d_out):
    layer = SparseGATLayer(d_in, d_out, dropout=0.0)
    layer.load_state_dict(sparse_gat_layer_params_from_jax(params))
    return layer


@pytest.mark.parametrize("d_in,d_out", [(5, 8), (16, 4)])
def test_rectangular_layer_matches_jax(d_in, d_out):
    """``forward(graph, x_src, x_dst)``, ``impl="torch"``, against the JAX
    layer's ``(graph, x_src, x_dst)`` on a 30 x 12 graph."""
    gt, gj, rng = rect_graphs(d_in)
    x_src = rng.standard_normal((30, d_in)).astype(np.float32)
    x_dst = rng.standard_normal((12, d_in)).astype(np.float32)
    params, want = jax_layer(gj, x_src, x_dst, d_out, d_in)
    layer = port_layer(params, d_in, d_out)
    got = layer(gt, torch.from_numpy(x_src), torch.from_numpy(x_dst),
                train=False, impl="torch")
    assert got.shape == (30, d_out)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                               atol=TOL)
    assert not got[0].any()     # the empty source row


def test_square_layer_defaults_x_dst_to_x_src():
    """On a square graph ``x_dst`` defaults to ``x_src``, as ``SparseGAT``
    passes ``x`` twice, and both match JAX's ``(graph, x, x)``."""
    rng = np.random.default_rng(3)
    dense = ((rng.random((20, 20)) < 0.2)
             * rng.integers(1, 5, (20, 20))).astype(np.float32)
    gt = tg.BipartiteGraph.from_dense(dense, pad_to_multiple=16)
    gj = jg.BipartiteGraph.from_dense(dense, pad_to_multiple=16)
    x = rng.standard_normal((20, 6)).astype(np.float32)
    params, want = jax_layer(gj, x, x, 4, 3)
    layer = port_layer(params, 6, 4)
    xt = torch.from_numpy(x)
    one = layer(gt, xt, train=False, impl="torch")
    two = layer(gt, xt, xt, train=False, impl="torch")
    assert torch.equal(one, two)
    np.testing.assert_allclose(one.detach().numpy(), want, rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_column_softmax_matches_jax(impl):
    """``edge_softmax(per="dst")`` against the JAX package's, whose
    ``impl="pallas"`` takes its XLA path for the column softmax; the
    port's ``impl="cuda"`` takes its plain path there (no raise)."""
    gt, gj, rng = rect_graphs(7)
    logits = (rng.standard_normal(gt.num_padded_edges) * 3).astype(
        np.float32)
    want = np.asarray(jax_edge_softmax(gj, jnp.asarray(logits), per="dst",
                                       impl="pallas"))
    got = edge_softmax(gt, torch.from_numpy(logits), per="dst", impl=impl)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=1e-7)
    e = gt.num_edges
    assert not got[e:].any()
    cols = gt.receivers[:e].long()
    sums = torch.zeros(12).index_add_(0, cols, got[:e])
    assert torch.allclose(sums[torch.bincount(cols, minlength=12) > 0],
                          torch.tensor(1.0), atol=1e-6)
