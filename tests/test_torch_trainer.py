"""The port's flow-model trainer against the JAX package's, on the CPU.

The same flow graph (numpy, from a seed) goes into both packages and the
flax variables go into the port's models (``gcn_params_from_jax``,
``msha_params_from_jax``), so both start from the same weights; the
batches are the same numpy draws.  One epoch of ``Trainer.fit`` at dropout
0, batch 16 (the last batch padded), is held against the JAX
``Trainer.fit``: GCN against ``impl="pallas"`` (its SpMM in interpret
mode, about 2^-16 relative error), full MSHA and ablation3 against XLA.

Tolerances: the epoch loss and the eval report at rtol 1e-4, atol 1e-5
(float32 in another summation order, and the Pallas SpMM's error); the
parameters and the running statistics after the epoch at rtol 1e-4, atol
1e-4 (Adam divides by the root of the second moment, which turns
last-bit differences of small gradients into differences of the update
up to a fraction of ``lr`` = 1e-3).  The small pieces: the losses at rtol
1e-6, the optimisers against optax over 5 steps at rtol 1e-5, atol 1e-7,
the batches exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import msha_gnn_tpu.graph as jg
import msha_gnn_torch.graph as tg
from msha_gnn_tpu.data import train_test_split_records
from msha_gnn_tpu.training import Trainer as JaxTrainer
from msha_gnn_tpu.training import TrainState as JaxTrainState
from msha_gnn_tpu.training import adam_l2 as jax_adam_l2
from msha_gnn_tpu.training import gcn_task as jax_gcn_task
from msha_gnn_tpu.training import msha_task as jax_msha_task
from msha_gnn_tpu.training import nll_loss as jax_nll_loss
from msha_gnn_tpu.training import sgd_momentum as jax_sgd_momentum
from msha_gnn_tpu.training import trainer as jax_trainer
from msha_gnn_torch.models import gcn_params_from_jax, msha_params_from_jax
from msha_gnn_torch.training import (Trainer, TrainState, adam_l2,
                                     gcn_task, make_eval_step,
                                     make_train_multi_step, make_train_step,
                                     msha_task, nll_loss, sgd_momentum)
from msha_gnn_torch.training import trainer as port_trainer
from tests.test_torch_gcn import flow_arrays, make_flow

RTOL, ATOL = 1e-4, 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-4
BATCH, SEED = 16, 0


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


# ---------------------------------------------------------------------------
# small pieces
# ---------------------------------------------------------------------------

def test_nll_loss_and_its_weighted_form_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(12, 5)).astype(np.float32)
    logp = logits - np.log(np.exp(logits).sum(1, keepdims=True))
    labels = rng.integers(0, 5, 12)
    np.testing.assert_allclose(
        _np(nll_loss(torch.from_numpy(logp), torch.from_numpy(labels))),
        _np(jax_nll_loss(jnp.asarray(logp), jnp.asarray(labels))),
        rtol=1e-6)
    # the JAX train step's form: sum(per * w) / max(sum(w), 1); padded
    # rows (weight 0) add nothing, whatever their scores
    w = np.ones(12, np.float32)
    w[9:] = 0.0
    per = -jnp.take_along_axis(jnp.asarray(logp), jnp.asarray(labels)[:, None],
                               axis=1)[:, 0]
    want = jnp.sum(per * w) / jnp.maximum(w.sum(), 1.0)
    got = nll_loss(torch.from_numpy(logp), torch.from_numpy(labels),
                   torch.from_numpy(w))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)
    moved = logp.copy()
    moved[9:] -= 7.0
    np.testing.assert_array_equal(
        _np(nll_loss(torch.from_numpy(moved), torch.from_numpy(labels),
                     torch.from_numpy(w))), _np(got))
    np.testing.assert_allclose(
        _np(nll_loss(torch.from_numpy(logp[:9]),
                     torch.from_numpy(labels[:9]))), _np(got), rtol=1e-6)
    # an all-padding batch divides by 1, not 0
    zero = nll_loss(torch.from_numpy(logp), torch.from_numpy(labels),
                    torch.zeros(12))
    assert float(zero) == 0.0


@pytest.mark.parametrize("name,wd", [("adam_l2", 0.0), ("adam_l2", 5e-4),
                                     ("sgd_momentum", 0.0),
                                     ("sgd_momentum", 5e-4)])
def test_optimisers_match_optax_over_five_steps(name, wd):
    rng = np.random.default_rng(1)
    p0 = {"w": rng.normal(size=(4, 3)).astype(np.float32),
          "b": rng.normal(size=3).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(5)]
    lr = 1e-2
    tx = (jax_adam_l2(lr, wd) if name == "adam_l2"
          else jax_sgd_momentum(lr, 0.9, wd))
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(params)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in p0.items()}
    opt = (adam_l2(tparams.values(), lr, wd) if name == "adam_l2"
           else sgd_momentum(tparams.values(), lr, 0.9, wd))
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v)
                                        for k, v in g.items()},
                                       opt_state, params)
        params = optax.apply_updates(params, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in p0:
            np.testing.assert_allclose(_np(tparams[k]), _np(params[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("n,bs,shuffle", [(37, 8, True), (32, 8, True),
                                          (5, 16, False), (0, 4, True)])
def test_batches_are_the_jax_packages(n, bs, shuffle):
    got = list(port_trainer._batches(n, bs, shuffle=shuffle,
                                     rng=np.random.default_rng(3)))
    want = list(jax_trainer._batches(n, bs, shuffle=shuffle,
                                     rng=np.random.default_rng(3)))
    assert len(got) == len(want)
    for (gi, gw), (wi, ww) in zip(got, want):
        assert gi.dtype == wi.dtype and gw.dtype == ww.dtype
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gw, ww)
    gi, gw = port_trainer._stacked_batches(n, bs, shuffle=shuffle,
                                           rng=np.random.default_rng(3))
    wi, ww = jax_trainer._stacked_batches(n, bs, shuffle=shuffle,
                                          rng=np.random.default_rng(3))
    assert gi.dtype == wi.dtype and gw.dtype == ww.dtype
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gw, ww)


# ---------------------------------------------------------------------------
# one epoch against the JAX trainer
# ---------------------------------------------------------------------------

DIMS = dict(in_features=16, out_features=8)


def build(model, fg_j, fg_t):
    """The JAX task and initial variables, and the port's task and model
    loaded with them, at dropout 0."""
    if model == "gcn":
        task_j, variables, _ = jax_gcn_task(fg_j, nfeat=16, dropout=0.0,
                                            seed=SEED, impl="pallas")
        task, net = gcn_task(fg_t, nfeat=16, dropout=0.0, seed=SEED,
                             device="cpu")
        net.load_state_dict(gcn_params_from_jax(variables))
        return task_j, variables, task, net
    flags = dict(use_intra=model != "ablation3")
    task_j, variables, _ = jax_msha_task(fg_j, dropout=0.0, seed=SEED,
                                         **DIMS, **flags)
    task, net = msha_task(fg_t, dropout=0.0, seed=SEED, device="cpu",
                          **DIMS, **flags)
    net.load_state_dict(msha_params_from_jax(variables))
    return task_j, variables, task, net


def final_state_dict(model, state_j):
    if model == "gcn":
        return gcn_params_from_jax(state_j.params)
    return msha_params_from_jax({"params": state_j.params,
                                 "batch_stats": state_j.batch_stats})


@pytest.fixture(scope="module")
def flow():
    a = flow_arrays(1)
    train_ids, test_ids = train_test_split_records(len(a["src"]), 0.9, SEED)
    assert len(train_ids) % BATCH and len(test_ids) % BATCH  # padded
    return a, make_flow(jg, a), make_flow(tg, a), train_ids, test_ids


@pytest.mark.parametrize("model", ["gcn", "msha", "ablation3"])
def test_one_epoch_matches_the_jax_trainer(flow, model):
    a, fg_j, fg_t, train_ids, test_ids = flow
    task_j, variables, task, net = build(model, fg_j, fg_t)
    init_sd = {k: v.clone() for k, v in net.state_dict().items()}
    state_j = JaxTrainState.create(variables, task_j.tx)
    state_j, hist_j = JaxTrainer(
        task=task_j, src=a["src"], labels=a["dst"], batch_size=BATCH,
        seed=SEED).fit(state_j, train_ids, test_ids, 1,
                       rng_key=jax.random.key(SEED))
    state = TrainState.create(net, task.optimizer)
    state, hist = Trainer(task=task, src=a["src"], labels=a["dst"],
                          batch_size=BATCH, seed=SEED).fit(
        state, train_ids, test_ids, 1)
    steps = -(-len(train_ids) // BATCH)
    assert state.step == int(state_j.step) == steps
    (got,), (want,) = hist, hist_j
    assert list(got) == list(want)  # the JAX keys, in the JAX order
    # the scores are not uniform (a seed whose initial GCN is all-relu-0
    # would train nothing and test nothing)
    assert got["train_loss"] < np.log(a["m"]) - 1e-3
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    want_sd = final_state_dict(model, state_j)
    got_sd = net.state_dict()
    assert set(got_sd) == set(want_sd)
    for k, v in want_sd.items():
        np.testing.assert_allclose(_np(got_sd[k]), _np(v), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)
        if k.endswith((".mean", ".var")):  # trained running statistics
            assert not np.allclose(_np(v), _np(init_sd[k]))


def test_padding_rows_change_msha_scores_but_not_the_loss(flow):
    """Full MSHA's intra channels attend within the batch: the padded rows
    move the real rows' scores (kept, as in the JAX package), while their
    weight 0 keeps them out of the loss."""
    a, _, fg_t, _, _ = flow
    task, net = msha_task(fg_t, dropout=0.0, seed=SEED, device="cpu", **DIMS)
    state = TrainState.create(net, task.optimizer)
    rows = torch.tensor([3, 7, 11, 20])
    scores_a, _ = make_eval_step(task)(state, torch.cat([rows, torch.zeros(
        4, dtype=torch.long)]), torch.zeros(8, dtype=torch.long))
    scores_b, _ = make_eval_step(task)(state, torch.cat([rows, torch.full(
        (4,), 30)]), torch.zeros(8, dtype=torch.long))
    assert not torch.allclose(scores_a[:4], scores_b[:4])


def test_multi_step_is_the_steps_in_order(flow):
    """One dispatch of S steps leaves the state S single steps leave, and
    returns their mean loss."""
    a, _, fg_t, _, _ = flow
    rng = np.random.default_rng(5)
    idx = torch.from_numpy(rng.integers(0, a["n"], (3, BATCH)))
    lab = torch.from_numpy(rng.integers(0, a["m"], (3, BATCH)))
    w = torch.ones(3, BATCH)
    w[-1, 10:] = 0.0
    runs = []
    for multi in (True, False):
        task, net = msha_task(fg_t, dropout=0.5, seed=SEED, device="cpu",
                              **DIMS)
        state = TrainState.create(net, task.optimizer)
        gen = torch.Generator().manual_seed(9)
        if multi:
            loss = make_train_multi_step(task)(state, idx, lab, w, gen)
        else:
            step = make_train_step(task)
            loss = torch.stack([step(state, *b, gen)
                                for b in zip(idx, lab, w)]).mean()
        runs.append((float(loss), state.step, net.state_dict()))
    (l1, s1, sd1), (l2, s2, sd2) = runs
    assert l1 == l2 and s1 == s2 == 3
    for k in sd1:
        assert torch.equal(sd1[k], sd2[k]), k


def test_fit_writes_a_chrome_trace_when_asked(flow, tmp_path):
    """``fit(profile_dir=)`` writes ``trace.json`` with the phases
    annotated; without it nothing is written."""
    import json

    a, _, fg_t, train_ids, test_ids = flow
    task, net = gcn_task(fg_t, nfeat=8, seed=SEED, device="cpu")
    trainer = Trainer(task=task, src=a["src"], labels=a["dst"],
                      batch_size=BATCH, seed=SEED)
    out = tmp_path / "prof"
    trainer.fit(TrainState.create(net, task.optimizer), train_ids[:64],
                test_ids, 1, profile_dir=str(out))
    with open(out / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"train_epoch_0", "eval_0"} <= names
    trainer.fit(TrainState.create(net, task.optimizer), train_ids[:64],
                test_ids, 1, profile_dir=None)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["prof"]
