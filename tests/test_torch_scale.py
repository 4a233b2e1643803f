"""The port's out-of-core training loop (``msha_gnn_torch/training/
scale.py``) against the JAX package's (``training/scale.py``), on the CPU.

The JAX operators run in interpret mode (``ChunkedRank1Gat``,
``ChunkedSpmm``, ``SegmentSoftmaxOperator``), built as the JAX
``train_chunked`` builds them; the port's loss comes from
``build_chunked``, which ``train_chunked`` runs.  The port starts from the
JAX initial parameters through ``convert.scale_params_from_jax`` and
draws its batches from the same ``np.random.default_rng(cfg.seed)`` in the
same order, so the two runs take the same steps.

Tolerances: the loss at rtol 1e-5 and each gradient at 1e-4 of its
largest value (float32 sums in another order and the JAX kernels' hi/lo
products, about 1.5e-5 of each; measured 9e-8 and 4e-6); three Adam steps'
losses at 1e-4 relative; the port's fused and materialised first losses
within 1e-3 of each other, the JAX test's bound
(``tests/test_chunked_rank1.py:116-131``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msha_gnn_tpu.ops.chunked import ChunkedSpmm as JaxChunkedSpmm
from msha_gnn_tpu.ops.chunked_rank1 import ChunkedRank1Gat as JaxChunkedGat
from msha_gnn_tpu.ops.pallas.softmax import \
    SegmentSoftmaxOperator as JaxSoftmax
from msha_gnn_tpu.training import scale as jax_scale
from msha_gnn_torch.models.convert import scale_params_from_jax
from msha_gnn_torch.training import scale

N, E, SLICES = 120, 900, 3
LOSS_RTOL, GRAD_REL, HISTORY_RTOL = 1e-5, 1e-4, 1e-4


@pytest.fixture(scope="module")
def edges():
    rng = np.random.default_rng(0)
    s = rng.integers(0, N, E).astype(np.int32)
    r = rng.integers(0, N, E).astype(np.int32)
    order = np.argsort(s, kind="stable")
    return s[order], r[order]


CFG = scale.ScaleConfig(d=8, steps=3, batch_edges=128, seed=3)


def jax_loss(s, r, fused):
    """The JAX ``train_chunked``'s loss, its operators in interpret mode."""
    cfg = jax_scale.ScaleConfig(d=CFG.d, steps=CFG.steps,
                                batch_edges=CFG.batch_edges, seed=CFG.seed)
    if fused:
        op = JaxChunkedGat(s, r, n_src=N, n_dst=N, num_slices=SLICES,
                           interpret=True, assume_sorted=True)
        return jax_scale._make_loss(None, None, N, None, cfg,
                                    attention_fn=lambda c, a, h: op(c, a, h))
    op = JaxChunkedSpmm.from_host_coo(s, r, None, n_src=N, n_dst=N,
                                      num_slices=SLICES, interpret=True,
                                      assume_sorted=True)
    ptr = np.concatenate([[0], np.cumsum(np.bincount(s, minlength=N))])
    return jax_scale._make_loss(jnp.asarray(s), jnp.asarray(r), N,
                                lambda h, att: op.apply(h, att), cfg,
                                softmax=JaxSoftmax(s, ptr, N,
                                                   interpret=True))


@pytest.mark.parametrize("fused", [True, False])
def test_loss_and_gradients_match_jax(edges, fused):
    s, r = edges
    params_j = jax_scale._init_params(jax.random.key(CFG.seed), N, CFG.d)
    params = {k: v.requires_grad_() for k, v in
              scale_params_from_jax(params_j).items()}
    batch = scale.draw_batch(np.random.default_rng(CFG.seed), s, r, N,
                             CFG.batch_edges, "cpu")
    loss_j, grads_j = jax.value_and_grad(jax_loss(s, r, fused))(
        params_j, *(jnp.asarray(b.numpy().astype(np.int32)) for b in batch))
    loss_fn, s_sorted, _, k = scale.build_chunked(
        s, r, N, CFG, num_slices=SLICES, fused=fused, device="cpu")
    assert k == SLICES and np.array_equal(s_sorted, s)
    loss = loss_fn(params, *batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                               rtol=LOSS_RTOL)
    for name, p in params.items():
        want = np.asarray(grads_j[name])
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=GRAD_REL * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("fused", [True, False])
def test_three_steps_match_jax_train(edges, fused):
    """``_train`` from the JAX initial parameters against the JAX
    ``_train``: the same batches, Adam at ``optax.adam``'s defaults."""
    s, r = edges
    params_j = jax_scale._init_params(jax.random.key(CFG.seed), N, CFG.d)
    cfg_j = jax_scale.ScaleConfig(d=CFG.d, steps=CFG.steps,
                                  batch_edges=CFG.batch_edges, seed=CFG.seed)
    want = jax_scale._train(jax_loss(s, r, fused), params_j, s, r, N,
                            cfg_j)["loss_history"]
    loss_fn, *_ = scale.build_chunked(s, r, N, CFG, num_slices=SLICES,
                                      fused=fused, device="cpu")
    logged = []
    got = scale._train(loss_fn, scale_params_from_jax(params_j), s, r, N,
                       CFG, log=logged.append)
    np.testing.assert_allclose(got["loss_history"], want, rtol=HISTORY_RTOL)
    assert [d["step"] for d in logged] == [0, 1, 2]
    assert set(got) == {"loss_history", "first_loss", "final_loss",
                        "loss_decreased", "step_seconds", "edges_per_s",
                        "edges"}
    assert got["edges"] == E and got["first_loss"] == got["loss_history"][0]


def test_train_chunked_fused_matches_materialised():
    """The JAX test's case: identical first loss from identical init, and
    the fused loss falls."""
    rng = np.random.default_rng(42)
    s, r = rng.integers(0, 200, 3000), rng.integers(0, 200, 3000)
    cfg = scale.ScaleConfig(d=8, steps=2, batch_edges=64)
    events = []
    res_f = scale.train_chunked(s, r, 200, cfg, num_slices=3, device="cpu",
                                log=events.append)
    res_m = scale.train_chunked(s, r, 200, cfg, num_slices=3, device="cpu",
                                fused=False)
    assert res_f["attention"] == "fused-rank1-chunked"
    assert res_m["attention"] == "materialized"
    assert res_f["topology"] == "single-chip out-of-core"
    assert abs(res_f["first_loss"] - res_m["first_loss"]) < 1e-3
    assert res_f["loss_decreased"]
    assert events[0]["event"] == "layout" and events[0]["num_slices"] == 3


def test_num_slices_and_init():
    assert scale.num_slices_for(50_000_000, 32) == 12
    assert scale.num_slices_for(3000, 8) == 1
    res = scale.train_chunked(np.arange(40) % 10, np.arange(40) % 7, 10,
                              scale.ScaleConfig(d=4, steps=1, batch_edges=8),
                              device="cpu")
    assert res["num_slices"] == 1
    p = scale._init_params(torch.Generator().manual_seed(0), 50, 16)
    g = 1.414 * (6.0 / 32) ** 0.5
    assert p["feat"].shape == (50, 16) and 0 <= float(p["feat"].min())
    assert float(p["feat"].max()) < 1
    assert p["a"].shape == (32,) and float(p["W"].abs().max()) < g
