"""The port's MSHA serving path against the JAX package's, on the CPU.

The same flow graph (numpy, from a seed) goes into both packages, and the
flax variables go into the port's modules through
``msha_params_from_jax``.  The norms' parameters and running statistics
are redrawn from a seed first, so the eval path reads statistics that
are not the identity.  Tolerance: rtol 1e-4, atol 1e-5 on log-scores and
gradients (float32, other summation orders; the JAX side at ``highest``
matmul precision).  Nothing here reaches a Pallas kernel: the JAX model
is XLA code throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msha_gnn_tpu.graph as jg
import msha_gnn_tpu.ops as jops
import msha_gnn_torch.graph as tg
import msha_gnn_torch.ops as tops
from msha_gnn_tpu.models import MSHALayer as JaxMSHALayer
from msha_gnn_tpu.models.gat import MaskedGATLayer as JaxMaskedGAT
from msha_gnn_tpu.serving import Predictor as JaxPredictor
from msha_gnn_tpu.training import msha_task as jax_msha_task
from msha_gnn_torch.models import (MSHALayer, MaskedGATLayer,
                                   msha_layer_params_from_jax,
                                   msha_params_from_jax)
from msha_gnn_torch.models.common import BatchNorm
from msha_gnn_torch.ops.dense import dropout
from msha_gnn_torch.serving import Predictor
from msha_gnn_torch.training import msha_task
from msha_gnn_torch.utils import TrainConfig
from tests.test_torch_gcn import flow_arrays, make_flow

RTOL, ATOL = 1e-4, 1e-5
DIMS = dict(in_features=16, out_features=8)
PRESETS = ("msha", "ours", "ablation1", "ablation2", "ablation3")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def close(got, want, err_msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL,
                               err_msg=err_msg)


def t(a):
    return torch.from_numpy(np.array(a))


def flags_of(preset):
    flags = TrainConfig(model=preset).model_flags()
    return flags.pop("n_heads", 2), flags


def redraw_norms(variables, seed):
    """``variables`` with every norm's scale, bias, mean and var drawn
    from ``seed`` (var positive)."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(lambda x: x, dict(variables["params"]))
    stats = jax.tree_util.tree_map(lambda x: x,
                                   dict(variables["batch_stats"]))
    att = dict(params["attention"])
    att_stats = dict(stats["attention"])
    for bn in ("bn1", "bn2"):
        f = att[bn]["scale"].shape[0]
        att[bn] = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, f), jnp.float32),
                   "bias": jnp.asarray(rng.normal(0, 0.2, f), jnp.float32)}
        att_stats[bn] = {
            "mean": jnp.asarray(rng.normal(0, 0.3, f), jnp.float32),
            "var": jnp.asarray(rng.uniform(0.2, 2.0, f), jnp.float32)}
    params["attention"] = att
    stats["attention"] = att_stats
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def flow():
    a = flow_arrays(3)
    return a, make_flow(jg, a), make_flow(tg, a)


@pytest.fixture(scope="module")
def presets(flow):
    """Per preset: the JAX task and model, its variables with redrawn
    norms, and the port's task and model loaded with them."""
    _, fg_j, fg_t = flow
    out = {}
    for i, preset in enumerate(PRESETS):
        n_heads, flags = flags_of(preset)
        task_j, variables, model_j = jax_msha_task(
            fg_j, n_heads=n_heads, **DIMS, **flags)
        variables = redraw_norms(variables, i)
        task, model = msha_task(fg_t, n_heads=n_heads, device="cpu",
                                **DIMS, **flags)
        model.load_state_dict(msha_params_from_jax(variables))
        out[preset] = (task_j, variables, model_j, task, model)
    return out


# ---------------------------------------------------------------------------
# graph, segment, dense and grouped ops
# ---------------------------------------------------------------------------

def test_pair_grouping_matches_jax(flow):
    _, fg_j, fg_t = flow
    want = jg.PairGrouping.build(fg_j.city, fg_j.province)
    got = tg.PairGrouping.build(fg_t.city, fg_t.province)
    assert got.num_pairs == want.num_pairs
    for k in ("pair_id", "a_of_pair", "b_of_pair"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), k)
    moved = got.to("cpu")
    assert moved.num_pairs == got.num_pairs
    assert fg_t.city.to("cpu").num_groups == fg_t.city.num_groups


@pytest.mark.parametrize("stable", [True, False])
def test_segment_additions_match_jax(stable):
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 7, 50).astype(np.int32)
    ids[[3, 9]] = 6                       # out of range: dropped
    vals = rng.random(50).astype(np.float32)
    logits = rng.normal(0, 2, 50).astype(np.float32)
    rows = rng.normal(size=(50, 3)).astype(np.float32)
    mask = rng.random(50) < 0.8
    close(tops.segment_normalize(t(vals), t(ids), 6),
          jops.segment_normalize(jnp.asarray(vals), jnp.asarray(ids), 6))
    close(tops.segment_mean(t(rows), t(ids), 6),
          jops.segment_mean(jnp.asarray(rows), jnp.asarray(ids), 6))
    close(tops.segment_mean(t(vals), t(ids), 9),   # empty segments: 0
          jops.segment_mean(jnp.asarray(vals), jnp.asarray(ids), 9))
    close(tops.segment_softmax(t(logits), t(ids), 6, mask=t(mask),
                               stable=stable),
          jops.segment_softmax(jnp.asarray(logits), jnp.asarray(ids), 6,
                               mask=jnp.asarray(mask), stable=stable))


def test_dense_ops_match_jax():
    rng = np.random.default_rng(12)
    h_src = rng.normal(size=(20, 6)).astype(np.float32)
    h_dst = rng.normal(size=(5, 6)).astype(np.float32)
    a = rng.normal(size=(12, 1)).astype(np.float32)
    mask = rng.random((20, 5)) < 0.5
    mask[4] = False                       # a row with no edge: uniform
    e = rng.normal(size=(20, 5)).astype(np.float32)
    got = tops.masked_row_softmax(t(e), t(mask))
    close(got, jops.masked_row_softmax(jnp.asarray(e), jnp.asarray(mask)))
    close(got[4], np.full(5, 0.2, np.float32))
    assert tops.MASK_VALUE == jops.MASK_VALUE == -9e15
    close(tops.bipartite_rank1_logits(t(h_src), t(h_dst), t(a)),
          jops.bipartite_rank1_logits(*map(jnp.asarray, (h_src, h_dst, a))))
    close(tops.self_concat_logits(t(h_src), t(a)),
          jops.self_concat_logits(jnp.asarray(h_src), jnp.asarray(a)))
    close(tops.pairwise_rank1_logits(t(h_src), t(h_src[::-1].copy()), t(a)),
          jops.pairwise_rank1_logits(jnp.asarray(h_src),
                                     jnp.asarray(h_src[::-1].copy()),
                                     jnp.asarray(a)))


def test_dropout_draws_from_its_generator():
    x = torch.ones(4000)
    assert dropout(x, 0.5, generator=None, deterministic=True) is x
    assert dropout(x, 0.0, generator=None, deterministic=False) is x
    one = dropout(x, 0.25, generator=torch.Generator().manual_seed(3),
                  deterministic=False)
    two = dropout(x, 0.25, generator=torch.Generator().manual_seed(3),
                  deterministic=False)
    assert torch.equal(one, two)
    assert set(one.unique().tolist()) == {0.0, float(np.float32(1 / 0.75))}
    assert abs(float((one == 0).float().mean()) - 0.25) < 0.03


def _grouped_inputs(fg_j, fg_t, seed):
    rng = np.random.default_rng(seed)
    batch = rng.integers(0, fg_t.n_src, 24).astype(np.int32)
    c_a = rng.normal(size=(24, 5)).astype(np.float32)
    c_b = rng.normal(size=(24, 5)).astype(np.float32)
    return batch, c_a, c_b


def test_grouped_ops_match_jax(flow):
    _, fg_j, fg_t = flow
    batch, c_a, c_b = _grouped_inputs(fg_j, fg_t, 13)
    jb = jnp.asarray(batch)
    rng = np.random.default_rng(14)
    h_b = rng.normal(size=(24, 4)).astype(np.float32)
    a = rng.normal(size=(8, 1)).astype(np.float32)
    w = rng.random(24).astype(np.float32)
    logit = tops.clique_row_scalar_logits(t(h_b), t(a))
    close(logit, jops.clique_row_scalar_logits(jnp.asarray(h_b),
                                               jnp.asarray(a)))
    close(tops.clique_exp_row_sum(logit, fg_t.city, t(batch)),
          jops.clique_exp_row_sum(jnp.asarray(logit.numpy()), fg_j.city, jb))
    for gt_, gj_ in ((fg_t.city, fg_j.city), (fg_t.province, fg_j.province)):
        close(tops.group_scatter(t(c_a), gt_, t(batch)),
              jops.group_scatter(jnp.asarray(c_a), gj_, jb))
        close(tops.clique_weighted_scatter(t(w), t(c_a), gt_, t(batch)),
              jops.clique_weighted_scatter(jnp.asarray(w), jnp.asarray(c_a),
                                           gj_, jb))
        denom = rng.uniform(1, 3, 24).astype(np.float32)
        close(tops.clique_masked_softmax_dense(logit, gt_, t(batch),
                                               t(denom)),
              jops.clique_masked_softmax_dense(jnp.asarray(logit.numpy()),
                                               gj_, jb, jnp.asarray(denom)))
    pair_t = tg.PairGrouping.build(fg_t.city, fg_t.province)
    pair_j = jg.PairGrouping.build(fg_j.city, fg_j.province)
    got = tops.pair_scatter(t(c_a), t(c_b), fg_t.city, fg_t.province,
                            pair_t, t(batch))
    close(got, jops.pair_scatter(jnp.asarray(c_a), jnp.asarray(c_b),
                                 fg_j.city, fg_j.province, pair_j, jb))
    close(got, tops.group_scatter(t(c_a), fg_t.city, t(batch))
          + tops.group_scatter(t(c_b), fg_t.province, t(batch)))


def test_grouped_gradients_match_jax_vjp(flow):
    """``take_rows``, ``gather_by_group`` and ``pair_scatter`` are plain
    indexing in the port; their autograd scatter-add against the JAX
    one-hot custom VJPs."""
    from msha_gnn_tpu.ops.grouped import gather_by_group as jax_gather

    _, fg_j, fg_t = flow
    batch, c_a, c_b = _grouped_inputs(fg_j, fg_t, 15)
    batch[:4] = batch[4]                     # repeated rows accumulate
    rng = np.random.default_rng(16)
    x = rng.normal(size=(fg_t.n_src, 5)).astype(np.float32)

    def check(port_fn, jax_fn, ins, ct):
        tin = [t(v).requires_grad_() for v in ins]
        out = port_fn(*tin)
        want, vjp = jax.vjp(jax_fn, *map(jnp.asarray, ins))
        close(out, want)
        out.backward(t(ct))
        for got, w in zip(tin, vjp(jnp.asarray(ct))):
            close(got.grad, w)

    check(lambda v: tops.take_rows(v, t(batch)),
          lambda v: jops.take_rows(v, jnp.asarray(batch)), [x],
          rng.normal(size=(24, 5)).astype(np.float32))
    table = rng.normal(size=(fg_t.city.num_groups, 5)).astype(np.float32)
    check(lambda v: tops.gather_by_group(v, fg_t.city.group_id),
          lambda v: jax_gather(v, fg_j.city.group_id), [table],
          rng.normal(size=(fg_t.n_src, 5)).astype(np.float32))
    pair_t = tg.PairGrouping.build(fg_t.city, fg_t.province)
    pair_j = jg.PairGrouping.build(fg_j.city, fg_j.province)
    check(lambda u, v: tops.pair_scatter(u, v, fg_t.city, fg_t.province,
                                         pair_t, t(batch)),
          lambda u, v: jops.pair_scatter(u, v, fg_j.city, fg_j.province,
                                         pair_j, jnp.asarray(batch)),
          [c_a, c_b], rng.normal(size=(fg_t.n_src, 5)).astype(np.float32))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_masked_gat_layer_matches_jax():
    rng = np.random.default_rng(17)
    x = rng.normal(size=(30, 10)).astype(np.float32)
    mask = rng.random((30, 5)) < 0.5
    mask[7] = False
    layer_j = JaxMaskedGAT(10, 5, 0.5)
    variables = layer_j.init(jax.random.key(0), jnp.asarray(x),
                             jnp.asarray(mask), train=False)
    want = layer_j.apply(variables, jnp.asarray(x), jnp.asarray(mask),
                         train=False)
    layer = MaskedGATLayer(10, 5, 0.5)
    layer.load_state_dict({k: t(v) for k, v in variables["params"].items()})
    close(layer(t(x), t(mask), train=False), want)


@pytest.mark.parametrize("use_intra,joint_softmax",
                         [(True, True), (True, False), (False, True)])
def test_msha_layer_matches_jax(flow, use_intra, joint_softmax):
    a, fg_j, fg_t = flow
    rng = np.random.default_rng(18)
    s_in = rng.random((a["n"], 16)).astype(np.float32)
    r_in = rng.random((a["m"], 16)).astype(np.float32)
    batch = rng.integers(0, a["n"], 12).astype(np.int32)
    rows = batch[::2].copy()
    mask_j = fg_j.inter.to_dense() > 0
    mask_t = fg_t.inter.to_dense() > 0
    pair_j = jg.PairGrouping.build(fg_j.city, fg_j.province)
    pair_t = tg.PairGrouping.build(fg_t.city, fg_t.province)
    kw = dict(use_intra=use_intra, joint_softmax=joint_softmax, n_heads=2)
    layer_j = JaxMSHALayer(16, 8, 0.5, **kw)
    args_j = (jnp.asarray(s_in), jnp.asarray(r_in), mask_j, fg_j.city,
              fg_j.province, jnp.asarray(batch))
    variables = layer_j.init(jax.random.key(1), *args_j, train=False,
                             pair=pair_j)
    variables = redraw_norms({"params": {"attention": variables["params"]},
                              "batch_stats": {"attention":
                                              variables["batch_stats"]}}, 5)
    variables = {"params": variables["params"]["attention"],
                 "batch_stats": variables["batch_stats"]["attention"]}
    layer = MSHALayer(16, 8, 0.5, **kw)
    layer.load_state_dict(msha_layer_params_from_jax(
        variables["params"], variables["batch_stats"]))
    args_t = (t(s_in), t(r_in), mask_t, fg_t.city, fg_t.province, t(batch))
    for r_j, r_t in ((None, None), (jnp.asarray(rows), t(rows))):
        for p_j, p_t in ((pair_j, pair_t), (None, None)):
            want = layer_j.apply(variables, *args_j, train=False, rows=r_j,
                                 pair=p_j)
            got = layer(*args_t, train=False, rows=r_t, pair=p_t)
            close(got, want)


# ---------------------------------------------------------------------------
# the model, the task and the predictor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", PRESETS)
def test_msha_eval_scores_match_jax(presets, flow, preset):
    a = flow[0]
    task_j, variables, _, task, model = presets[preset]
    batch = np.random.default_rng(19).integers(0, a["n"], 20).astype(np.int32)
    want, _ = task_j.forward(variables, jnp.asarray(batch), train=False,
                             rngs=None)
    got, mutated = task.forward(model, batch, train=False)
    assert got.shape == (20, a["m"]) and mutated == {}
    close(got, want)
    np.testing.assert_allclose(got.exp().sum(dim=1).detach().numpy(), 1.0,
                               rtol=1e-5)
    if preset == "ablation3":
        assert task_j.full_scores is not None
        full = task.full_scores(model)
        close(full, task_j.full_scores(variables))
        close(full[torch.from_numpy(batch).long()], got)
    else:
        assert task.full_scores is None and task_j.full_scores is None


@pytest.mark.parametrize("preset", ["msha", "ablation3"])
def test_train_forward_updates_statistics_as_flax(presets, flow, preset):
    """A train-mode forward at dropout 0: the log-scores, the running
    statistics flax returns under ``mutable=["batch_stats"]`` (momentum
    0.9, biased variance), and the parameters' gradients."""
    _, fg_j, fg_t = flow
    _, variables, model_j, _, _ = presets[preset]
    n_heads, flags = flags_of(preset)
    model_j = model_j.clone(dropout=0.0)
    task, model = msha_task(fg_t, n_heads=n_heads, dropout=0.0,
                            device="cpu", **DIMS, **flags)
    model.load_state_dict(msha_params_from_jax(variables))
    rng = np.random.default_rng(20)
    batch = rng.integers(0, fg_t.n_src, 16).astype(np.int32)
    weights = rng.normal(size=(16, fg_t.n_dst)).astype(np.float32)
    mask_j = fg_j.inter.to_dense() > 0
    pair = (jg.PairGrouping.build(fg_j.city, fg_j.province)
            if flags["use_intra"] else None)

    def loss(params):
        logp, mutated = model_j.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            mask_j, fg_j.city, fg_j.province, jnp.asarray(batch),
            train=True, mutable=["batch_stats"], rows=jnp.asarray(batch),
            pair=pair)
        return jnp.sum(logp * jnp.asarray(weights)), (logp, mutated)

    (_, (want, mutated)), grads = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    got, _ = task.forward(model, batch, train=True)
    close(got, want)
    (got * t(weights)).sum().backward()
    want_sd = msha_params_from_jax({"params": variables["params"],
                                    "batch_stats": mutated["batch_stats"]})
    sd = model.state_dict()
    for bn in ("bn1", "bn2"):
        for k in ("mean", "var"):
            name = f"attention.{bn}.{k}"
            close(sd[name], want_sd[name], name)
    want_grads = msha_params_from_jax({"params": grads,
                                       "batch_stats": mutated["batch_stats"]})
    for name, p in model.named_parameters():
        close(p.grad, want_grads[name], name)


def test_batch_norm_running_statistics():
    """flax's update: ``0.9 * old + 0.1 * batch``, the variance biased."""
    bn = BatchNorm(3)
    x = torch.from_numpy(np.random.default_rng(21).normal(
        2.0, 3.0, (32, 3)).astype(np.float32))
    y = bn(x, train=True)
    torch.testing.assert_close(bn.mean, 0.1 * x.mean(0))
    torch.testing.assert_close(bn.var, 0.9 + 0.1 * x.var(0, unbiased=False))
    torch.testing.assert_close(y.mean(0), torch.zeros(3), atol=1e-5,
                               rtol=0)
    before = bn.mean.clone()
    bn(x, train=False)
    assert torch.equal(bn.mean, before)


@pytest.mark.parametrize("preset", ["msha", "ablation2"])
def test_predictor_per_batch_path_matches_jax(presets, flow, preset):
    """Chunks padded with node 0 to ``batch_size``; 37 nodes in chunks of
    16 (the last chunk 5 real rows)."""
    a = flow[0]
    task_j, variables, _, task, model = presets[preset]
    nodes = np.random.default_rng(22).integers(0, a["n"], 37)
    want = JaxPredictor(task_j, variables, batch_size=16).log_scores(nodes)
    pred = Predictor(task, model, batch_size=16)
    got = pred.log_scores(nodes)
    assert got.shape == (37, a["m"]) and pred._full is None
    close(got, want)
    # the last chunk is one padded forward's first rows
    padded = np.concatenate([nodes[32:], np.zeros(11, np.int64)])
    last, _ = task.forward(model, padded, train=False)
    np.testing.assert_array_equal(got[32:], last[:5].detach().numpy())
    top = pred.top_k(nodes[:3], k=2)
    assert [r["node"] for r in top] == nodes[:3].tolist()


def test_msha_task_defaults_to_cuda(flow):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        msha_task(flow[2], **DIMS)
