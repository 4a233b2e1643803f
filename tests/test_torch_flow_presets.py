"""The port's other flow presets (``gat``, ``sage``, ``hgane``) against the
JAX package's, on the CPU.

The same flow graph (numpy, from a seed) goes into both packages, and the
flax variables go into the port's models (``gat_params_from_jax``,
``sage_params_from_jax``, ``hgane_params_from_jax``), so both compute with
the same weights.  None of these models reaches a Pallas kernel: the JAX
models are XLA code throughout.

Tolerances: the forwards at rtol 1e-5, atol 1e-6 (float32, other
summation orders); one epoch of ``Trainer.fit`` at the bounds of
``tests/test_torch_trainer.py`` (losses and report rtol 1e-4, atol 1e-5,
parameters and running statistics rtol 1e-4, atol 1e-4); the dense rows
and the scipy graph exactly.  The forwards in training run at dropout 0
(the two packages draw their masks from different generators).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import msha_gnn_tpu.graph as jg
import msha_gnn_torch.graph as tg
from msha_gnn_tpu.data import train_test_split_records
from msha_gnn_tpu.models import GAT as JaxGAT
from msha_gnn_tpu.models import GraphSAGE as JaxGraphSAGE
from msha_gnn_tpu.models import HGANELayer as JaxHGANELayer
from msha_gnn_tpu.models import gather_dense_rows as jax_gather_dense_rows
from msha_gnn_tpu.serving import Predictor as JaxPredictor
from msha_gnn_tpu.training import Trainer as JaxTrainer
from msha_gnn_tpu.training import TrainState as JaxTrainState
from msha_gnn_tpu.training import gat_task as jax_gat_task
from msha_gnn_tpu.training import hgane_task as jax_hgane_task
from msha_gnn_tpu.training import sage_task as jax_sage_task
from msha_gnn_torch import cli
from msha_gnn_torch.models import (GAT, GraphSAGE, HGANELayer,
                                   gat_params_from_jax, gather_dense_rows,
                                   hgane_params_from_jax,
                                   sage_params_from_jax)
from msha_gnn_torch.serving import Predictor
from msha_gnn_torch.training import (Trainer, TrainState, gat_task,
                                     hgane_task, sage_task)
from tests.test_torch_gcn import flow_arrays, make_flow
from tests.test_torch_serving import write_data_dir

RTOL, ATOL = 1e-5, 1e-6
FIT_RTOL, FIT_ATOL = 1e-4, 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-4
BATCH, SEED = 16, 0
PRESETS = ("gat", "sage", "hgane")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=err_msg)


@pytest.fixture(scope="module")
def flow():
    a = flow_arrays(5)
    return a, make_flow(jg, a), make_flow(tg, a)


def redraw_norms(variables, seed):
    """HGANE's variables with both norms' scale, bias, mean and var drawn
    from ``seed`` (var positive), so eval reads statistics that are not
    the identity."""
    rng = np.random.default_rng(seed)
    params = dict(variables["params"])
    stats = dict(variables["batch_stats"])
    for bn in ("bn1", "bn2"):
        f = params[bn]["scale"].shape[0]
        params[bn] = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, f),
                                           jnp.float32),
                      "bias": jnp.asarray(rng.normal(0, 0.2, f),
                                          jnp.float32)}
        stats[bn] = {"mean": jnp.asarray(rng.normal(0, 0.3, f), jnp.float32),
                     "var": jnp.asarray(rng.uniform(0.2, 2.0, f),
                                        jnp.float32)}
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# graph pieces
# ---------------------------------------------------------------------------

def test_from_scipy_matches_jax():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 30, 200)
    cols = rng.integers(0, 7, 200)  # duplicates: summed
    vals = rng.random(200).astype(np.float32)
    mx = sp.coo_matrix((vals, (rows, cols)), shape=(30, 7)).tocsr()
    got = tg.from_scipy(mx, pad_to_multiple=64)
    want = jg.from_scipy(mx, pad_to_multiple=64)
    assert (got.n_src, got.n_dst, got.num_edges) == (
        want.n_src, want.n_dst, want.num_edges)
    for name in ("senders", "receivers", "weight", "row_ptr"):
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(_np(got.to_dense()), mx.toarray(), rtol=1e-6)


def test_gather_dense_rows_matches_jax(flow):
    _, fg_j, fg_t = flow
    g_j = jg.normalize_by_dst_degree(fg_j.inter)
    g_t = tg.normalize_by_dst_degree(fg_t.inter)
    rows = np.asarray([0, 5, fg_t.n_src - 1, 5, 17], np.int32)
    max_deg = int(np.diff(_np(g_t.row_ptr)).max())
    got = gather_dense_rows(g_t, torch.from_numpy(rows), max_deg)
    want = jax_gather_dense_rows(g_j, jnp.asarray(rows), max_deg)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(_np(got), _np(g_t.to_dense())[rows])


# ---------------------------------------------------------------------------
# the forwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("rows", [None, [3, 0, 41, 3]])
def test_gat_forward_matches_jax(flow, train, rows):
    a, fg_j, fg_t = flow
    mask = fg_t.inter.to_dense() > 0
    model_j = JaxGAT(n_features=6, n_classes=a["m"], n_heads=3, dropout=0.0,
                     gdp=fg_j.gdp)
    variables = model_j.init(jax.random.key(1), jnp.asarray(_np(mask)),
                             train=False)
    model = GAT(6, a["m"], 3, 0.0, gdp=fg_t.gdp)
    model.load_state_dict(gat_params_from_jax(variables))
    r = None if rows is None else np.asarray(rows, np.int32)
    want = model_j.apply(variables, jnp.asarray(_np(mask)), train=train,
                         rows=None if r is None else jnp.asarray(r))
    got = model(mask, train=train,
                rows=None if r is None else torch.from_numpy(r))
    assert got.shape == want.shape
    close(got, want)
    # an explicit x replaces the learnable features
    x = np.random.default_rng(2).random((a["n"], 6)).astype(np.float32)
    close(model(mask, torch.from_numpy(x), train=False),
          model_j.apply(variables, jnp.asarray(_np(mask)), jnp.asarray(x),
                        train=False))


def test_gat_dropout_draws_from_the_generator(flow):
    a, _, fg_t = flow
    mask = fg_t.inter.to_dense() > 0
    model = GAT(6, a["m"], 2, 0.5, gdp=fg_t.gdp,
                generator=torch.Generator().manual_seed(0))
    outs = [model(mask, train=True,
                  generator=torch.Generator().manual_seed(s))
            for s in (7, 7, 8)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


def test_graphsage_forward_matches_jax(flow):
    a, fg_j, fg_t = flow
    g_t = tg.normalize_by_dst_degree(fg_t.inter)
    dense = g_t.to_dense()
    batch = np.asarray([4, 0, 9, 4, a["n"] - 1], np.int32)
    model_j = JaxGraphSAGE(in_features=8, hidden_features=a["m"],
                           out_features=a["m"], gdp=fg_j.gdp)
    variables = model_j.init(jax.random.key(3), jnp.asarray(batch),
                             jnp.asarray(_np(dense)[batch]), train=False)
    model = GraphSAGE(8, a["m"], a["m"], gdp=fg_t.gdp)
    model.load_state_dict(sage_params_from_jax(variables))
    want = model_j.apply(variables, jnp.asarray(batch),
                         jnp.asarray(_np(dense)[batch]), train=False)
    got = model(torch.from_numpy(batch), dense[batch.astype(np.int64)])
    close(got, want)


@pytest.mark.parametrize("intra", ["city", "province"])
@pytest.mark.parametrize("train", [False, True])
def test_hgane_forward_matches_jax(flow, intra, train):
    a, fg_j, fg_t = flow
    mask = _np(fg_t.inter.to_dense() > 0)
    batch = np.random.default_rng(4).integers(0, a["n"], 24).astype(np.int32)
    model_j = JaxHGANELayer(in_features=12, out_features=6, n_src=a["n"],
                            n_dst=a["m"], dropout=0.0)
    grouping_j = fg_j.city if intra == "city" else fg_j.province
    variables = redraw_norms(model_j.init(
        jax.random.key(5), jnp.asarray(mask[:1]), grouping_j,
        jnp.zeros((1,), jnp.int32), train=False), 6)
    model = HGANELayer(12, 6, a["n"], a["m"], 0.0)
    model.load_state_dict(hgane_params_from_jax(variables))
    grouping = fg_t.city if intra == "city" else fg_t.province
    out = model_j.apply(variables, jnp.asarray(mask[batch]), grouping_j,
                        jnp.asarray(batch), train=train,
                        mutable=["batch_stats"] if train else False)
    want, mutated = out if train else (out, None)
    got = model(torch.from_numpy(mask[batch]), grouping,
                torch.from_numpy(batch), train=train)
    assert got.shape == (24, a["m"])
    close(got, want)
    if train:  # the running statistics, updated as flax updates them
        sd = hgane_params_from_jax({"params": variables["params"],
                                    "batch_stats": mutated["batch_stats"]})
        for k in ("bn1.mean", "bn1.var", "bn2.mean", "bn2.var"):
            close(model.state_dict()[k], sd[k], err_msg=k)


# ---------------------------------------------------------------------------
# one epoch against the JAX trainer, the predictor, the CLI
# ---------------------------------------------------------------------------

DIMS = {"gat": {}, "sage": dict(in_features=8),
        "hgane": dict(in_features=12, out_features=6)}
JAX_TASKS = {"gat": jax_gat_task, "sage": jax_sage_task,
             "hgane": jax_hgane_task}
TASKS = {"gat": gat_task, "sage": sage_task, "hgane": hgane_task}
CONVERT = {"gat": gat_params_from_jax, "sage": sage_params_from_jax,
           "hgane": hgane_params_from_jax}


def build(model, fg_j, fg_t, dropout=0.0):
    """The JAX task and variables, and the port's task and model loaded
    with them."""
    task_j, variables, _ = JAX_TASKS[model](fg_j, dropout=dropout, seed=SEED,
                                            **DIMS[model])
    task, net = TASKS[model](fg_t, dropout=dropout, seed=SEED, device="cpu",
                             **DIMS[model])
    net.load_state_dict(CONVERT[model](variables))
    return task_j, variables, task, net


def state_dict_of(model, state_j):
    if model == "hgane":
        return hgane_params_from_jax({"params": state_j.params,
                                      "batch_stats": state_j.batch_stats})
    return CONVERT[model](state_j.params)


@pytest.fixture(scope="module")
def split(flow):
    a = flow[0]
    train_ids, test_ids = train_test_split_records(len(a["src"]), 0.9, SEED)
    assert len(train_ids) % BATCH and len(test_ids) % BATCH  # padded
    return train_ids, test_ids


@pytest.mark.parametrize("model", PRESETS)
def test_one_epoch_matches_the_jax_trainer(flow, split, model):
    a, fg_j, fg_t = flow
    train_ids, test_ids = split
    task_j, variables, task, net = build(model, fg_j, fg_t)
    state_j = JaxTrainState.create(variables, task_j.tx)
    state_j, hist_j = JaxTrainer(
        task=task_j, src=a["src"], labels=a["dst"], batch_size=BATCH,
        seed=SEED).fit(state_j, train_ids, test_ids, 1,
                       rng_key=jax.random.key(SEED))
    state = TrainState.create(net, task.optimizer)
    state, hist = Trainer(task=task, src=a["src"], labels=a["dst"],
                          batch_size=BATCH, seed=SEED).fit(
        state, train_ids, test_ids, 1)
    assert state.step == int(state_j.step) == -(-len(train_ids) // BATCH)
    (got,), (want,) = hist, hist_j
    assert list(got) == list(want)
    # not uniform scores (a model that learns nothing tests nothing)
    assert abs(got["train_loss"] - np.log(a["m"])) > 1e-3
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=FIT_RTOL,
                                   atol=FIT_ATOL, err_msg=k)
    want_sd, got_sd = state_dict_of(model, state_j), net.state_dict()
    assert set(got_sd) == set(want_sd)
    for k, v in want_sd.items():
        close(got_sd[k], v, PARAM_RTOL, PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("model", PRESETS)
def test_predictor_matches_jax(flow, model):
    """GAT through the cache fill; GraphSAGE and HGANE through the
    per-batch path, chunks padded with node 0 (HGANE's intra block makes
    the padding part of its scores), 37 nodes in chunks of 16."""
    a, fg_j, fg_t = flow
    task_j, variables, task, net = build(model, fg_j, fg_t, dropout=0.5)
    if model == "hgane":
        variables = redraw_norms(variables, 8)
        net.load_state_dict(hgane_params_from_jax(variables))
    nodes = np.random.default_rng(9).integers(0, a["n"], 37)
    want = JaxPredictor(task_j, variables, batch_size=16).log_scores(nodes)
    pred = Predictor(task, net, batch_size=16)
    got = pred.log_scores(nodes)
    assert got.shape == (37, a["m"])
    assert (task.full_scores is not None) == (model == "gat")
    close(got, want, 1e-4, 1e-5)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return write_data_dir(tmp_path_factory.mktemp("flow") / "data",
                          flow_arrays(4))


def last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("model", PRESETS)
def test_cli_train_eval_predict(data_dir, tmp_path, capsys, model):
    ckpt = str(tmp_path / "ckpt")
    args = ["--model", model, "--data_dir", data_dir, "--in_features", "16",
            "--out_features", "8", "--batch_size", "16", "--seed", "3",
            "--device", "cpu", "--checkpoint_dir", ckpt]
    assert cli.main(["train", *args, "--epochs", "1"]) == 0
    trained = last_json(capsys.readouterr().out)
    assert all(np.isfinite(v) for v in trained.values())
    assert cli.main(["eval", *args]) == 0
    evaluated = last_json(capsys.readouterr().out)
    for k in ("auc", "accuracy", "loss"):
        np.testing.assert_allclose(evaluated[k], trained[k], rtol=1e-6,
                                   err_msg=k)
    assert cli.main(["predict", *args, "--nodes", "0,1,2", "--top_k",
                     "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line)["node"] for line in lines[:3]] == [0, 1, 2]
    assert json.loads(lines[-1])["checkpoint_step"] == \
        evaluated["checkpoint_step"]
