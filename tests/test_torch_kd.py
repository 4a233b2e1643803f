"""The port's LLP pipeline (``msha_gnn_torch/training/kd.py``) and KD
losses against the JAX package's, on the CPU at a tiny size.

* the KD losses against ``msha_gnn_tpu.training.losses`` (float64 within
  1e-6, float32 within 1e-6 relative);
* the teacher's embedding and one LLP step (loss parts and gradients,
  padded batch weights, sampled KD-only pairs at label weight 0, with and
  without the margin-rank term, the shipped ``final_linear=False``
  predictor) against the JAX GAT / MLP / LinkPredictor at dropout 0, the
  weights carried by ``llp_params_from_jax``; the loss as
  ``msha_gnn_tpu/training/kd.py`` forms it.  Loss rtol 1e-4; gradients
  rtol 2e-3, atol 1e-3 (``tests/test_torch_linkpred.py``'s);
* an epoch's arrays (observed records, 'nb' / 'rw' sampled pairs,
  permutation, padding, negatives) against the arrays the JAX run hands
  its scanned epoch, recorded from ``run_llp`` itself;
* ``run_llp`` end to end in both evaluation modes, the val split and
  early stopping, and the configuration guards (``tests/test_kd.py``'s).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msha_gnn_torch.graph as tg
import msha_gnn_tpu.graph as jg
from msha_gnn_tpu.models import GAT as JaxGAT
from msha_gnn_tpu.models import MLP as JaxMLP
from msha_gnn_tpu.models import LinkPredictor as JaxLinkPredictor
from msha_gnn_tpu.training import kd as jax_kd
from msha_gnn_tpu.training import losses as jax_losses
from msha_gnn_tpu.utils import LLPConfig as JaxLLPConfig
from msha_gnn_torch.data import train_test_split_records
from msha_gnn_torch.models import llp_params_from_jax
from msha_gnn_torch.training import kd, losses
from msha_gnn_torch.utils import LLPConfig
from tests.test_torch_gcn import flow_arrays, make_flow

LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-3
M = 8


def tiny_cfg(**kw):
    """hidden == M, as the cosine term needs."""
    base = dict(num_layers=2, hidden_channels=M, epochs=2, batch_size=64,
                seed=0, teacher_heads=2)
    base.update(kw)
    return LLPConfig(**base)


@pytest.fixture(scope="module")
def flows():
    a = flow_arrays(3, n=60, m=M, records=400)
    return make_flow(tg, a), make_flow(jg, a)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_kd_losses_match_jax(dtype):
    rng = np.random.default_rng(1)
    s, t = (rng.standard_normal((50, 8)).astype(dtype) for _ in range(2))
    s[3] = 0.0   # a zero row: the eps inside the sqrt
    ps, ns = (rng.random(50).astype(dtype) for _ in range(2))
    label = dtype(0.37)
    rtol = 1e-6
    with jax.enable_x64(dtype == np.float64):
        want = {
            "kd_cosine": jax_losses.kd_cosine(jnp.asarray(s), jnp.asarray(t)),
            "mse": jax_losses.mse_loss(jnp.asarray(ps), jnp.asarray(ns)),
            "margin": jax_losses.margin_rank_loss(jnp.asarray(ps),
                                                  jnp.asarray(ns), 0.2),
        }
        total_j, parts_j = jax_losses.kd_loss(
            jnp.asarray(label), jnp.asarray(s), jnp.asarray(t),
            jnp.asarray(ps), jnp.asarray(ns), kd_f=0.3, kd_p=50.0)
        want = {k: float(v) for k, v in want.items()}
        total_j = float(total_j)
        parts_j = {k: float(v) for k, v in parts_j.items()}
    ts, tt, tps, tns = (torch.from_numpy(v) for v in (s, t, ps, ns))
    got = {"kd_cosine": losses.kd_cosine(ts, tt),
           "mse": losses.mse_loss(tps, tns),
           "margin": losses.margin_rank_loss(tps, tns, 0.2)}
    for k, v in got.items():
        assert v.dtype == ts.dtype
        np.testing.assert_allclose(float(v), want[k], rtol=rtol, err_msg=k)
    total, parts = losses.kd_loss(torch.tensor(label), ts, tt, tps, tns,
                                  kd_f=0.3, kd_p=50.0)
    np.testing.assert_allclose(float(total), total_j, rtol=rtol)
    for k, v in parts.items():
        np.testing.assert_allclose(float(v), parts_j[k], rtol=rtol, err_msg=k)
    # the teacher is detached
    ts.requires_grad_()
    tt.requires_grad_()
    losses.kd_cosine(ts, tt).backward()
    assert tt.grad is None and torch.isfinite(ts.grad).all()


@pytest.fixture(scope="module")
def jax_llp(flows):
    """The JAX LLP models at dropout 0 on the tiny flow graph: the
    teacher's embedding, and the loss, parts and gradients of one batch
    (records with padding and KD-only pairs) per case."""
    _, fg_j = flows
    n, d = fg_j.n_src, M
    rng = np.random.default_rng(2)
    features = rng.random((n, M)).astype(np.float32)
    mask = np.asarray(fg_j.inter.to_dense()) > 0
    k_s, k_p, k_t, k_tp = jax.random.split(jax.random.key(3), 4)
    trees = {}
    models = {}
    for final_linear in (True, False):
        student = JaxMLP(num_layers=2, hidden_dim=d, output_dim=d,
                         dropout_ratio=0.0)
        predictor = JaxLinkPredictor(predictor="mlp", hidden_channels=d,
                                     num_layers=2, dropout=0.0,
                                     final_linear=final_linear)
        teacher = JaxGAT(n_features=M, n_classes=M, n_heads=2, dropout=0.0)
        teacher_predictor = JaxLinkPredictor(
            predictor="mlp", hidden_channels=M, num_layers=2, dropout=0.0,
            final_linear=final_linear)
        z = jnp.zeros((1, d))
        trees[final_linear] = {
            "student": student.init(k_s, jnp.asarray(features),
                                    train=False)["params"],
            "predictor": predictor.init(k_p, z, z, train=False)["params"],
            "teacher": teacher.init(k_t, jnp.asarray(mask),
                                    jnp.asarray(features),
                                    train=False)["params"],
            "teacher_predictor": teacher_predictor.init(
                k_tp, z, z, train=False)["params"],
        }
        models[final_linear] = (student, predictor, teacher,
                                teacher_predictor)
    t_h = models[True][2].apply({"params": trees[True]["teacher"]},
                                jnp.asarray(mask), jnp.asarray(features),
                                train=False)
    b = 48
    src, dst = np.asarray(fg_j.edge_src), np.asarray(fg_j.edge_dst)
    pos_s = np.concatenate([src[:40], rng.integers(0, n, 8)]).astype(np.int32)
    pos_r = np.concatenate([dst[:40], rng.integers(0, M, 8)]).astype(np.int32)
    neg_r = rng.integers(0, M, b).astype(np.int32)
    w = np.ones(b, np.float32)
    w[-5:] = 0.0                     # padding
    lbl = np.ones(b, np.float32)
    lbl[36:] = 0.0                   # KD-only pairs
    batch = (pos_s, pos_r, neg_r, w, lbl)

    def wmean(x, w):
        if x.ndim > 1:
            x = x.mean(axis=tuple(range(1, x.ndim)))
        return jnp.sum(x * w) / jnp.maximum(jnp.sum(w), 1.0)

    def loss_fn(params, cfg, final_linear, t_h):
        student, predictor, _, teacher_predictor = models[final_linear]
        tp_vars = {"params": trees[final_linear]["teacher_predictor"]}
        pos_s, pos_r, neg_r, w, lbl = (jnp.asarray(v) for v in batch)
        idx = jnp.concatenate([pos_s, pos_r, neg_r])
        h3 = student.apply({"params": params["student"]},
                           jnp.asarray(features)[idx], train=True)
        h_ps, h_pr, h_nr = jnp.split(h3, 3)
        pos_score = predictor.apply({"params": params["predictor"]}, h_ps,
                                    h_pr, train=True)
        neg_score = predictor.apply({"params": params["predictor"]}, h_ps,
                                    h_nr, train=True)
        w_lbl = w * lbl
        pos_c = jnp.clip(pos_score, 1e-7, 1.0 - 1e-7)
        neg_c = jnp.clip(neg_score, 1e-7, 1.0 - 1e-7)
        label = 0.5 * (wmean(-jnp.log(pos_c), w_lbl)
                       + wmean(-jnp.log(1.0 - neg_c), w_lbl))
        t_pos = teacher_predictor.apply(tp_vars, t_h[pos_s], t_h[pos_r],
                                        train=False)
        t_det = jax.lax.stop_gradient(t_h[pos_s])
        cos_row = jnp.sum(h_ps * t_det, axis=-1) / jnp.sqrt(
            (jnp.sum(h_ps * h_ps, axis=-1) + 1e-8)
            * (jnp.sum(t_det * t_det, axis=-1) + 1e-8))
        cos = 1.0 - wmean(cos_row, w)
        mse = wmean((pos_score - jax.lax.stop_gradient(t_pos)) ** 2, w)
        total = cfg.true_label * label + cfg.kd_f * cos + cfg.kd_p * mse
        parts = {"label": label, "kd_cosine": cos, "kd_mse": mse}
        if cfg.kd_rank > 0.0:
            t_neg = teacher_predictor.apply(tp_vars, t_h[pos_s], t_h[neg_r],
                                            train=False)
            sign = jax.lax.stop_gradient(jnp.sign(t_pos - t_neg))
            rank = wmean(jax.nn.relu(
                cfg.margin - sign * (pos_score - neg_score)), w)
            total = total + cfg.kd_rank * rank
            parts["kd_rank"] = rank
        return total, parts

    def step(cfg):
        fl = cfg.final_linear
        params = {k: trees[fl][k] for k in ("student", "predictor")}
        (loss, parts), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, cfg, fl, t_h)
        return float(loss), {k: float(v) for k, v in parts.items()}, grads

    return dict(features=features, mask=mask, t_h=np.array(t_h),
                trees=trees, batch=batch, step=step)


def port_model(jax_llp, fg, cfg):
    model = kd.LLPModel(fg.n_src, M, fg.gdp, cfg)
    tree = jax_llp["trees"][cfg.final_linear]
    sd = {**llp_params_from_jax(tree),
          "features": torch.from_numpy(jax_llp["features"])}
    model.load_state_dict(sd)
    return model


def test_teacher_embedding_matches_jax(flows, jax_llp):
    fg, _ = flows
    model = port_model(jax_llp, fg, tiny_cfg(dropout=0.0))
    got = model.teacher_embedding(fg.inter.to_dense() > 0)
    np.testing.assert_allclose(got.numpy(), jax_llp["t_h"], rtol=1e-5,
                               atol=1e-6)
    assert not any(p.requires_grad for p in model.teacher.parameters())
    assert len(model.trained_parameters()) == 8


@pytest.mark.parametrize("kd_rank,final_linear",
                         [(0.0, True), (0.5, True), (0.5, False)])
def test_llp_step_matches_jax(flows, jax_llp, kd_rank, final_linear):
    fg, _ = flows
    cfg = tiny_cfg(dropout=0.0, kd_rank=kd_rank, final_linear=final_linear)
    want_loss, want_parts, want_grads = jax_llp["step"](cfg)
    model = port_model(jax_llp, fg, cfg)
    t_h = torch.from_numpy(jax_llp["t_h"])
    batch = [torch.from_numpy(v) for v in jax_llp["batch"]]
    loss, parts = kd.llp_loss_parts(model, t_h, *batch, cfg)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=LOSS_RTOL)
    assert set(parts) == set(want_parts)
    for k, v in parts.items():
        np.testing.assert_allclose(v.item(), want_parts[k], rtol=LOSS_RTOL,
                                   err_msg=k)
    loss.backward()
    tree = jax_llp["trees"][final_linear]
    want = llp_params_from_jax({**tree, **want_grads})
    got = dict(model.named_parameters())
    trained = {k for k, p in got.items() if p.requires_grad}
    assert trained == {k for k in want if k.startswith(("student.",
                                                         "predictor."))}
    for name in trained:
        np.testing.assert_allclose(got[name].grad.numpy(),
                                   want[name].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


class _Recorder:
    """``jnp`` for ``msha_gnn_tpu.training.kd``, keeping a copy of every
    2-D numpy array the run hands ``jnp.asarray``: its scanned epoch's
    ``[S, B]`` inputs, five an epoch."""

    def __init__(self):
        self.seen = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def asarray(self, a, *args, **kw):
        if isinstance(a, np.ndarray) and a.ndim == 2:
            self.seen.append(a.copy())
        return jnp.asarray(a, *args, **kw)


@pytest.mark.parametrize("method", ["none", "nb", "rw"])
def test_epoch_arrays_match_jax(flows, monkeypatch, method):
    """Two epochs' arrays against those the JAX ``run_llp`` feeds its
    scanned epoch, from the same seed; the batch does not divide the
    records, so the last batch is padded."""
    fg, fg_j = flows
    kw = dict(epochs=2, batch_size=64, seed=5, hops=2, rw_step=2)
    if method != "none":
        kw.update(ps_samples=30, ps_method=method)
    rec = _Recorder()
    monkeypatch.setattr(jax_kd, "jnp", rec)
    jax_kd.run_llp(JaxLLPConfig(**{**dataclasses.asdict(tiny_cfg()), **kw}),
                   fg=fg_j)
    assert len(rec.seen) == 10
    cfg = tiny_cfg(**kw)
    src, dst = fg.edge_src.numpy(), fg.edge_dst.numpy()
    train_ids, _ = train_test_split_records(fg.num_records, 0.9, cfg.seed)
    rev = fg.inter.transpose() if method == "rw" else None
    rng = np.random.default_rng(cfg.seed)
    for epoch in range(2):
        got = kd.llp_epoch_arrays(rng, cfg, src, dst, train_ids, fg, rev)
        want = rec.seen[5 * epoch: 5 * epoch + 5]
        for name, g, w in zip(("pos_s", "pos_r", "neg_r", "w", "lbl"), got,
                              want):
            assert g.shape == w.shape and g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=f"{epoch} {name}")
        w, lbl = got[3], got[4]
        labelled = float((w * lbl).sum())
        assert labelled == len(train_ids)
        assert (w.sum() > labelled) == (method != "none")


@pytest.mark.parametrize("mode", ["link", "multiclass"])
def test_run_llp_end_to_end(flows, mode):
    fg, _ = flows
    logs = []
    kw = dict(eval_mode="multiclass", final_linear=False, metric="auc") \
        if mode == "multiclass" else dict(ps_samples=20, kd_rank=0.1)
    result = kd.run_llp(tiny_cfg(**kw), log=logs.append, fg=fg,
                        device="cpu")
    epochs = [r for r in logs if r["event"] == "llp_train_epoch"]
    assert len(epochs) == 2 and logs[-1]["event"] == "llp_eval"
    assert np.isfinite(result["final_train_loss"])
    if mode == "link":
        assert all("kd_rank" in r for r in epochs)
        assert 0.0 <= result["auc"] <= 1.0
        assert 0.0 <= result["hits@20"] <= result["hits@50"] <= 1.0
    else:
        for k in ("auc", "accuracy", "precision_macro", "f1_macro"):
            assert k in result and np.isfinite(result[k]), k


def test_run_llp_val_split_and_early_stopping(flows):
    """At lr 0 the validation score never improves after the first
    evaluation, so patience 1 stops the run at the second; the best state
    is restored, and the teacher sees the train records only."""
    fg, _ = flows
    logs = []
    cfg = tiny_cfg(epochs=6, eval_steps=1, patience=1, val_fraction=0.2,
                   metric="auc", lr=0.0)
    result = kd.run_llp(cfg, log=logs.append, fg=fg, device="cpu")
    vals = [r for r in logs if r["event"] == "llp_val"]
    assert len(vals) == 2 and result["early_stopped_epoch"] == 1
    assert result["best_val_auc"] == vals[0]["auc"]
    both = kd.run_llp(dataclasses.replace(cfg, use_valedges_as_input=True,
                                          lr=5e-3, epochs=2, patience=100),
                      fg=fg, device="cpu")
    assert np.isfinite(both["best_val_auc"])


def test_teacher_mask_follows_the_split(flows):
    fg, _ = flows
    ids = np.arange(fg.num_records)
    full = kd.teacher_mask(fg, tiny_cfg(), ids, ids[:0], "cpu")
    assert torch.equal(full, fg.inter.to_dense() > 0)
    cfg = tiny_cfg(val_fraction=0.5)
    train, val = ids[:100], ids[100:200]
    part = kd.teacher_mask(fg, cfg, train, val, "cpu")
    assert int(part.sum()) < int(full.sum())
    more = kd.teacher_mask(fg, dataclasses.replace(
        cfg, use_valedges_as_input=True), train, val, "cpu")
    assert bool((more >= part).all()) and int(more.sum()) > int(part.sum())


@pytest.mark.parametrize("kw", [
    dict(final_linear=False),
    dict(eval_mode="multiclass"),
    dict(eval_mode="multiclass", final_linear=False, predictor="inner"),
    dict(eval_mode="multiclass", final_linear=False, metric="hits@20"),
    dict(eval_mode="bogus"),
    dict(hidden_channels=M + 1),
])
def test_guards_raise_as_jax(flows, kw):
    """The configurations the JAX run refuses, refused before training,
    with the same error type."""
    fg, fg_j = flows
    with pytest.raises(ValueError):
        jax_kd.run_llp(JaxLLPConfig(**{**dataclasses.asdict(tiny_cfg()),
                                       **kw}), fg=fg_j)
    with pytest.raises(ValueError):
        kd.run_llp(tiny_cfg(**kw), fg=fg, device="cpu")


def test_config_matches_jax():
    """LLPConfig field for field, with the JAX defaults; ``data_dir`` is
    relative to the working directory, as the port's TrainConfig's."""
    port = dataclasses.asdict(LLPConfig())
    jax_fields = dataclasses.asdict(JaxLLPConfig())
    assert list(port) == list(jax_fields)
    assert port.pop("data_dir") == "anonymous_data"
    jax_fields.pop("data_dir")
    assert port == jax_fields
