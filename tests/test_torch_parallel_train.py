"""The port's sharded training steps and ``train_distributed`` on K = 1, 2,
4 gloo ranks, against the JAX package's on as many virtual CPU devices and
against the port's own single-device steps, on the CPU.

Each K spawns its ranks once (``tests/torch_parallel_workers.py``, a
120 s deadline).  Held there:

* ``make_sharded_msha_step`` (BatchNorm and the intra channels on): at
  dropout 0 from the JAX initial weights, the first loss against the JAX
  ``make_sharded_msha_step`` at ``tests/test_parallel.py:93``'s rtol 5e-5
  (64 sources: the JAX mesh needs K to divide them), and on a flow of 16
  sources and 8 recipients, where ``in_features``, ``H d`` and ``M H``
  are 16 too (``bn1``, ``bn2``, ``out_att.W`` and ``out_att.a`` have 16
  rows: only ``Sfeatures`` may be cut to a rank's rows); on 61 sources (no K
  divides them) at dropout 0.5, three steps
  of full MSHA and of each ablation against the port's single-device
  step (``make_train_step``) from the same weights, batches and dropout
  generator: the losses at 5e-5, the parameters and running statistics
  after at 1e-4 (``tests/test_torch_trainer.py``'s bound: Adam turns
  last-bit differences of small gradients into a share of ``lr``);
* ``make_sharded_linkpred_step``, on 32 positives with 32 negatives and
  with 96 (each side split over the ranks and averaged over its own
  length): at dropout 0 from the JAX weights, the first loss against the
  JAX step at 5e-5; at dropout 0.5, two steps against the port's
  single-device ``linkpred_loss`` step at 5e-5;
* ``train_distributed``, fused and materialised, on edges in (sender,
  receiver) order and on the same edges shuffled: the edges its batches
  are drawn from against the JAX graph's CSR order, bit for bit; from the
  JAX initial
  parameters against the JAX ``train_distributed`` on the same input, and
  from the port's own against the port's ``train_chunked`` on the ordered
  edges, at ``tests/test_scale_training.py:29-30``'s rtol and atol 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msha_gnn_tpu.graph as jg
import msha_gnn_tpu.parallel as jpar
from msha_gnn_tpu.data.ogb import split_edges as jax_split_edges
from msha_gnn_tpu.data.ogb import synthetic_ddi as jax_synthetic_ddi
from msha_gnn_tpu.training import msha_task as jax_msha_task
from msha_gnn_tpu.training import scale as jax_scale
from msha_gnn_torch.data import split_edges, synthetic_ddi
from msha_gnn_torch.models import (linkpred_params_from_jax,
                                   msha_params_from_jax)
from msha_gnn_torch.models.convert import scale_params_from_jax
from msha_gnn_torch.training import TrainState, make_train_step, msha_task
from msha_gnn_torch.training import scale
from msha_gnn_torch.training.link_prediction import (LinkPredConfig,
                                                     LinkPredModel,
                                                     linkpred_loss)
from msha_gnn_torch.training.optim import adam_l2
from tests.test_torch_gcn import flow_arrays, make_flow
from tests.torch_parallel_workers import port_flow, spawn

KS = (1, 2, 4)
LOSS_RTOL = 5e-5                  # tests/test_parallel.py:93
PARAM_RTOL = PARAM_ATOL = 1e-4    # tests/test_torch_trainer.py
SCALE_TOL = 2e-4                  # tests/test_scale_training.py:29-30
MSHA_KW = dict(in_features=16, out_features=8, seed=3)
PRESETS = {
    "msha": dict(MSHA_KW),
    "ablation1": dict(MSHA_KW, n_heads=1, use_out_att=False),
    "ablation2": dict(MSHA_KW, joint_softmax=False),
    "ablation3": dict(MSHA_KW, use_intra=False),
}
STEPS, BATCH = 3, 16
# n_src = in_features = H d = M H: parameters other than Sfeatures have
# n_src rows
COLLIDE = dict(n=16, m=8, records=400)
LP = dict(ddi=dict(n=64, n_edges=600, seed=3),
          split=dict(num_neg=100, seed=3, pad_to_multiple=64),
          kwargs=dict(hidden=16, seed=5))
SCALE_N, SCALE_E = 120, 900
SCALE_CFG = dict(d=8, steps=3, batch_edges=128, seed=3)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    flow = flow_arrays(5, n=61, m=5, records=400)
    flow_jax = flow_arrays(6, n=64, m=5, records=400)  # the JAX mesh's N
    ids = rng.integers(0, len(flow["src"]), (STEPS, BATCH))
    weights = np.ones((STEPS, BATCH), np.float32)
    weights[-1, -3:] = 0.0      # a padded last batch
    batches = {"batch": torch.from_numpy(flow["src"][ids].astype(np.int64)),
               "labels": torch.from_numpy(flow["dst"][ids].astype(np.int64)),
               "weights": torch.from_numpy(weights)}
    _, jvars, _ = jax_msha_task(make_flow(jg, flow_jax), **MSHA_KW,
                                dropout=0.0)
    jax_state = msha_params_from_jax(jvars)
    flow_c = flow_arrays(7, **COLLIDE)
    ids_c = np.random.default_rng(17).integers(0, len(flow_c["src"]), BATCH)
    _, jvars_c, _ = jax_msha_task(make_flow(jg, flow_c), **MSHA_KW,
                                  dropout=0.0)
    collide = dict(flow=flow_c,
                   batch=[torch.from_numpy(flow_c["src"][ids_c]).long(),
                          torch.from_numpy(flow_c["dst"][ids_c]).long(),
                          torch.ones(BATCH)],
                   jax_state=msha_params_from_jax(jvars_c))

    jsplit = jax_split_edges(jax_synthetic_ddi(**LP["ddi"]), **LP["split"])
    b = 32
    pos_s, pos_r = (np.asarray(a[:b]).astype(np.int64)
                    for a in jsplit["train_pos"])
    neg = rng.integers(0, LP["ddi"]["n"], (2, b)).astype(np.int64)
    lp_batch = [pos_s, pos_r, neg[0], neg[1]]
    neg3 = np.random.default_rng(19).integers(
        0, LP["ddi"]["n"], (2, 3 * b)).astype(np.int64)
    lp_unequal = [pos_s, pos_r, neg3[0], neg3[1]]
    jstep, (jparams, _, _), _ = jpar.make_sharded_linkpred_step(
        jsplit, jpar.make_mesh(1, data_axis=1), **LP["kwargs"])
    lp_state = linkpred_params_from_jax(jparams)

    s = rng.integers(0, SCALE_N, SCALE_E).astype(np.int32)
    r = rng.integers(0, SCALE_N, SCALE_E).astype(np.int32)
    order = np.lexsort((r, s))  # the JAX graph's CSR order
    s, r = s[order], r[order]
    shuffle = np.random.default_rng(13).permutation(SCALE_E)
    jcfg = jax_scale.ScaleConfig(**SCALE_CFG)
    jparams0 = jax_scale._init_params(jax.random.key(jcfg.seed), SCALE_N,
                                      jcfg.d)
    inputs = dict(
        flow=flow, flow_jax=flow_jax, msha_presets=PRESETS,
        msha_batches=batches,
        msha_jax_state=jax_state, msha_collide=collide,
        linkpred=dict(LP, batch=lp_batch, unequal=lp_unequal,
                      jax_state=lp_state),
        scale=dict(s=s, r=r, s_shuffled=s[shuffle], r_shuffled=r[shuffle],
                   n=SCALE_N, cfg=SCALE_CFG,
                   jax_params={k: v.numpy() for k, v in
                               scale_params_from_jax(jparams0).items()}))
    return dict(inputs=inputs, jsplit=jsplit, jcfg=jcfg)


_PORT, _JAX = {}, {}


@pytest.fixture(scope="module")
def port(setup, tmp_path_factory):
    def run(k):
        if k not in _PORT:
            _PORT[k] = spawn("train", setup["inputs"], k,
                             tmp_path_factory.mktemp(f"train{k}"))
        return _PORT[k]
    return run


@pytest.fixture(scope="module")
def jax_ref(setup):
    """The JAX sharded steps' first losses and ``train_distributed``'s
    losses (ordered and shuffled edges) at ``k`` devices."""
    inp = setup["inputs"]

    def run(k):
        if k in _JAX:
            return _JAX[k]
        mesh = jpar.make_mesh(k, data_axis=k)
        step, state, (data_s, repl) = jpar.make_sharded_msha_step(
            make_flow(jg, inp["flow_jax"]), mesh, **MSHA_KW, dropout=0.0)
        b = {key: jnp.asarray(v[0].numpy()) for key, v in
             inp["msha_batches"].items()}
        _, msha_loss = step(state, *(jax.device_put(
            b[key].astype(jnp.int32 if key != "weights" else jnp.float32),
            data_s) for key in ("batch", "labels", "weights")),
            jax.device_put(jax.random.key(0), repl))
        c = inp["msha_collide"]
        step, state, (data_s, repl) = jpar.make_sharded_msha_step(
            make_flow(jg, c["flow"]), mesh, **MSHA_KW, dropout=0.0)
        _, collide_loss = step(state, *(jax.device_put(
            jnp.asarray(v.numpy().astype(dt)), data_s) for v, dt in
            zip(c["batch"], (np.int32, np.int32, np.float32))),
            jax.device_put(jax.random.key(0), repl))
        lp = {}
        for key in ("batch", "unequal"):
            step, (params, opt, graph), (data_s, repl) = \
                jpar.make_sharded_linkpred_step(setup["jsplit"], mesh,
                                                **LP["kwargs"])
            batch = [jax.device_put(jnp.asarray(v.astype(np.int32)), data_s)
                     for v in inp["linkpred"][key]]
            _, _, lp[key] = step(params, opt, graph, *batch,
                                 jax.device_put(jax.random.key(0), repl))
        sc = inp["scale"]
        hist = {f"{key}{edges}": jax_scale.train_distributed(
            sc[f"s{edges}"], sc[f"r{edges}"], SCALE_N, mesh, setup["jcfg"],
            fused=fused)["loss_history"]
            for key, fused in (("fused", True), ("materialised", False))
            for edges in ("", "_shuffled")}
        _JAX[k] = dict(msha=float(msha_loss), msha_collide=float(collide_loss),
                       linkpred=float(lp["batch"]),
                       linkpred_unequal=float(lp["unequal"]), scale=hist)
        return _JAX[k]
    return run


@pytest.fixture(scope="module")
def single(setup):
    """The port's single-device runs (the CPU, one process)."""
    inp = setup["inputs"]
    fg = port_flow(inp["flow"])
    msha = {}
    for preset, kw in PRESETS.items():
        task, model = msha_task(fg, **kw, device="cpu")
        state = TrainState.create(model, task.optimizer)
        step = make_train_step(task)
        gen = torch.Generator().manual_seed(0)
        b = inp["msha_batches"]
        losses = [float(step(state, b["batch"][i], b["labels"][i],
                             b["weights"][i], gen)) for i in range(STEPS)]
        msha[preset] = (losses, {k: v.detach().numpy() for k, v in
                                 model.state_dict().items()})

    lp = inp["linkpred"]
    split = split_edges(synthetic_ddi(**lp["ddi"]), **lp["split"])
    cfg = LinkPredConfig(hidden=16, dropout=0.5, seed=5)
    lp_losses = {}
    for key in ("batch", "unequal"):
        model = LinkPredModel(split["n"], cfg,
                              generator=torch.Generator().manual_seed(5))
        opt = adam_l2(model.parameters(), cfg.lr)
        gen = torch.Generator().manual_seed(0)
        batch = [torch.from_numpy(v) for v in lp[key]]
        lp_losses[key] = []
        for _ in range(2):
            opt.zero_grad(set_to_none=True)
            loss = linkpred_loss(model, split["graph"], batch, impl="torch",
                                 generator=gen)
            loss.backward()
            opt.step()
            lp_losses[key].append(float(loss.detach()))

    sc = inp["scale"]
    cfg = scale.ScaleConfig(**SCALE_CFG)
    chunked = {key: scale.train_chunked(sc["s"], sc["r"], SCALE_N, cfg,
                                        num_slices=3, fused=fused,
                                        device="cpu")["loss_history"]
               for key, fused in (("fused", True), ("materialised", False))}
    return dict(msha=msha, linkpred=lp_losses, chunked=chunked)


def test_inputs_agree_between_packages(setup):
    """The ddi split the ranks draw is the JAX split the reference uses."""
    lp = setup["inputs"]["linkpred"]
    split = split_edges(synthetic_ddi(**lp["ddi"]), **lp["split"])
    js = setup["jsplit"]
    for key in ("senders", "receivers", "row_ptr"):
        np.testing.assert_array_equal(getattr(split["graph"], key).numpy(),
                                      np.asarray(getattr(js["graph"], key)))


@pytest.mark.parametrize("k", KS)
def test_sharded_msha_step_matches_jax(port, jax_ref, k):
    want = jax_ref(k)["msha"]
    for res in port(k):
        np.testing.assert_allclose(res["msha_jax_loss"], want,
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_sharded_msha_steps_match_single_device(port, single, k, preset):
    losses, sd = single["msha"][preset]
    for res in port(k):
        np.testing.assert_allclose(res[f"msha/{preset}/losses"], losses,
                                   rtol=LOSS_RTOL)
        got = res[f"msha/{preset}/state"]
        assert set(got) == set(sd)
        for name, v in sd.items():
            np.testing.assert_allclose(got[name], v, rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=name)


@pytest.mark.parametrize("k", KS)
def test_sharded_msha_step_with_colliding_shapes_matches_jax(setup, port,
                                                            jax_ref, k):
    """Parameters other than ``Sfeatures`` with ``n_src`` rows stay whole:
    only the node-row table is cut to the ranks' rows."""
    n = COLLIDE["n"]
    collide = [name for name, v in
               setup["inputs"]["msha_collide"]["jax_state"].items()
               if name != "Sfeatures" and v.dim() and v.shape[0] == n]
    assert {"out_att.W", "out_att.a", "attention.bn1.scale"} <= set(collide)
    want = jax_ref(k)["msha_collide"]
    for res in port(k):
        assert res["msha_collide/rows"] == ["Sfeatures"]
        np.testing.assert_allclose(res["msha_collide_jax_loss"], want,
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("k", KS)
def test_sharded_linkpred_step_matches_jax(port, jax_ref, k):
    want = jax_ref(k)["linkpred"]
    for res in port(k):
        np.testing.assert_allclose(res["linkpred_jax_loss"], want,
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("k", KS)
def test_sharded_linkpred_dropout_matches_single_device(port, single, k):
    for res in port(k):
        np.testing.assert_allclose(res["linkpred_losses"],
                                   single["linkpred"]["batch"],
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("k", KS)
def test_sharded_linkpred_unequal_sides_match_jax(setup, port, jax_ref, k):
    """32 positives, 96 negatives: each side averaged over its own
    length."""
    pos_s, _, neg_s, _ = setup["inputs"]["linkpred"]["unequal"]
    assert 3 * len(pos_s) == len(neg_s)
    want = jax_ref(k)["linkpred_unequal"]
    for res in port(k):
        np.testing.assert_allclose(res["linkpred_unequal_jax_loss"], want,
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("k", KS)
def test_sharded_linkpred_unequal_sides_dropout_match_single_device(
        port, single, k):
    """The negatives' masks are drawn for all 96 rows, after the
    positives'."""
    for res in port(k):
        np.testing.assert_allclose(res["linkpred_unequal_losses"],
                                   single["linkpred"]["unequal"],
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("mode", ["fused", "materialised"])
def test_train_distributed_matches_jax(port, jax_ref, k, mode):
    want = jax_ref(k)["scale"][mode]
    for res in port(k):
        np.testing.assert_allclose(res[f"scale_jax/{mode}"], want,
                                   rtol=SCALE_TOL, atol=SCALE_TOL)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("mode", ["fused", "materialised"])
def test_train_distributed_draws_from_the_jax_edge_order(setup, port, k,
                                                         mode):
    """Given shuffled edges, ``build_distributed`` hands the batch draw the
    edges in the JAX graph's CSR order, (sender, receiver)."""
    sc = setup["inputs"]["scale"]
    g = jg.BipartiteGraph.from_coo(
        sc["s_shuffled"], sc["r_shuffled"], np.ones(SCALE_E, np.float32),
        n_src=SCALE_N, n_dst=SCALE_N, combine_duplicates=False)
    want = np.stack([np.asarray(g.senders)[:SCALE_E],
                     np.asarray(g.receivers)[:SCALE_E]])
    for res in port(k):
        np.testing.assert_array_equal(res[f"scale_shuffled_edges/{mode}"],
                                      want)
        np.testing.assert_array_equal(res[f"scale_edges/{mode}"], want)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("mode", ["fused", "materialised"])
def test_train_distributed_on_shuffled_edges_matches_jax(port, jax_ref, k,
                                                         mode):
    """Both packages draw their batches from the (sender, receiver) order,
    whatever the order of the input."""
    want = jax_ref(k)["scale"][f"{mode}_shuffled"]
    for res in port(k):
        np.testing.assert_allclose(res[f"scale_jax_shuffled/{mode}"], want,
                                   rtol=SCALE_TOL, atol=SCALE_TOL)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("mode", ["fused", "materialised"])
def test_train_distributed_on_shuffled_edges_matches_train_chunked(
        port, single, k, mode):
    """Shuffled, ``train_distributed`` draws the batches ``train_chunked``
    draws from the same edges in (sender, receiver) order."""
    for res in port(k):
        np.testing.assert_allclose(
            res[f"scale_shuffled/{mode}"]["loss_history"],
            single["chunked"][mode], rtol=SCALE_TOL, atol=SCALE_TOL)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("mode", ["fused", "materialised"])
def test_train_distributed_matches_train_chunked(port, single, k, mode):
    for res in port(k):
        out = res[f"scale/{mode}"]
        np.testing.assert_allclose(out["loss_history"],
                                   single["chunked"][mode], rtol=SCALE_TOL,
                                   atol=SCALE_TOL)
        assert out["topology"] == f"edge-partitioned x{k}"
        assert out["attention"] == ("fused-rank1-sharded" if mode == "fused"
                                    else "materialized")
        assert out["edges"] == SCALE_E and out["loss_decreased"]
        assert set(out) == {"loss_history", "first_loss", "final_loss",
                            "loss_decreased", "step_seconds", "edges_per_s",
                            "edges", "topology", "attention"}
