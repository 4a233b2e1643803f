"""``scripts_torch_convert_checkpoint.py``: a JAX package checkpoint
(orbax, ``msha_gnn_tpu/training/checkpoint.py``) carried into the port.

A tiny JAX state is trained one epoch on a written data directory and
saved; the script converts it; the port's ``cli eval`` of the result must
print JAX's metrics, and one further Adam step at dropout 0 from the
converted state must give JAX's next parameters and moments.  GCN and
full MSHA (its ``batch_stats`` and intra channels), with weight decay (an
optax chain) and without (Adam's state alone).

Tolerances: the metrics at rtol 1e-4, atol 1e-5 (float32 in another
summation order), the AUC at an absolute 1e-3: scores of different rows
that agree to 1e-6 can swap, and one swapped pair moves the macro AUC by
1 / (P N M), about 8e-4 on 40 test records of 5 classes; the step's
parameters and moments at rtol 1e-4 and an atol of 1e-4 of each tensor's
largest value (JAX's XLA step against torch's, one Adam update of at most
``lr``).  MSHA's ``out_att.a`` has an exact gradient of 0 (the output
layer's self-concat logits are constant per row, and a row softmax
ignores a constant), so without weight decay its new moments are float
noise in both packages and are not compared; its value is.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msha_gnn_tpu.graph as jg
import scripts_torch_convert_checkpoint as conv
from msha_gnn_tpu import cli as jax_cli
from msha_gnn_tpu.data import train_test_split_records
from msha_gnn_tpu.training import Trainer as JaxTrainer
from msha_gnn_tpu.training import TrainState as JaxTrainState
from msha_gnn_tpu.training import make_train_step as jax_make_train_step
from msha_gnn_tpu.training.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from msha_gnn_tpu.utils import TrainConfig as JaxTrainConfig
from msha_gnn_torch import cli
from msha_gnn_torch.data import load_flow_graph
from msha_gnn_torch.training import (TrainState, make_train_step,
                                     restore_checkpoint)
from msha_gnn_torch.utils import TrainConfig
from tests.test_torch_gcn import flow_arrays, make_flow
from tests.test_torch_serving import write_data_dir

RTOL, ATOL = 1e-4, 1e-5
AUC_ATOL = 1e-3
STEP_RTOL, STEP_ATOL_REL = 1e-4, 1e-4
BATCH = 16


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def close_rel(got, want, err_msg):
    got, want = _np(got), _np(want).reshape(_np(got).shape)
    atol = STEP_ATOL_REL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=STEP_RTOL, atol=atol,
                               err_msg=err_msg)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    a = flow_arrays(21, n=60, m=5, records=400)
    return a, write_data_dir(tmp_path_factory.mktemp("data"), a)


def flags(model, data_dir, wd, dropout):
    return ["--model", model, "--data_dir", data_dir, "--in_features", "8",
            "--out_features", "4", "--batch_size", str(BATCH),
            "--weight_decay", str(wd), "--dropout", str(dropout)]


@pytest.mark.parametrize("wd", [5e-4, 0.0], ids=["chain", "adam_alone"])
@pytest.mark.parametrize("model", ["gcn", "msha"])
def test_a_converted_checkpoint_evaluates_and_steps_as_jax(
        data, tmp_path, capsys, model, wd):
    a, data_dir = data
    fg_j = make_flow(jg, a)
    cfg_j = JaxTrainConfig(model=model, data_dir=data_dir, in_features=8,
                           out_features=4, batch_size=BATCH,
                           weight_decay=wd, dropout=0.0)
    task_j, variables = jax_cli._build_task(cfg_j, fg_j)
    state_j = JaxTrainState.create(variables, task_j.tx)
    train_ids, test_ids = train_test_split_records(400, 0.9, cfg_j.seed)
    trainer_j = JaxTrainer(task=task_j, src=a["src"], labels=a["dst"],
                           batch_size=BATCH, seed=cfg_j.seed)
    state_j, _ = trainer_j.fit(state_j, train_ids, test_ids, 1,
                               rng_key=jax.random.key(0))
    jax_dir = str(tmp_path / "jax_ckpt")
    jax_save_checkpoint(jax_dir, state_j, step=int(state_j.step))
    if wd:
        assert isinstance(state_j.opt_state, tuple) and \
            not hasattr(state_j.opt_state, "mu")
    assert conv.adam_state(state_j.opt_state) is not None

    port_dir = str(tmp_path / "port_ckpt")
    args = flags(model, data_dir, wd, 0.0)
    assert conv.main(["--jax_checkpoint_dir", jax_dir, "--checkpoint_dir",
                      port_dir, *args]) == 0
    summary = json.loads(capsys.readouterr().out.strip())
    assert summary["step"] == summary["adam_count"] == int(state_j.step)

    # cli eval of the converted checkpoint prints JAX's metrics
    assert cli.main(["eval", *args, "--checkpoint_dir", port_dir,
                     "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = trainer_j.evaluate(state_j, test_ids)
    assert got["checkpoint_step"] == int(state_j.step)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], float(v), rtol=RTOL,
                                   atol=AUC_ATOL if k == "auc" else ATOL,
                                   err_msg=k)

    # one more Adam step at dropout 0 from the converted state
    cfg = TrainConfig(model=model, data_dir=data_dir, in_features=8,
                      out_features=4, batch_size=BATCH, weight_decay=wd,
                      dropout=0.0, checkpoint_dir=port_dir)
    task, net = cli._build_task(cfg, load_flow_graph("2015", data_dir),
                                "cpu")
    state, _, step = restore_checkpoint(
        port_dir, TrainState.create(net, task.optimizer))
    assert step == state.step == int(state_j.step)
    ids = train_ids[:BATCH]
    w = np.ones(BATCH, np.float32)
    state_j2, loss_j = jax_make_train_step(task_j)(
        state_j, jnp.asarray(a["src"][ids]), jnp.asarray(a["dst"][ids]),
        jnp.asarray(w), jax.random.key(1))
    loss = make_train_step(task)(
        state, torch.from_numpy(a["src"][ids].astype(np.int64)),
        torch.from_numpy(a["dst"][ids].astype(np.int64)),
        torch.from_numpy(w))
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=RTOL,
                               atol=ATOL)
    want_sd = conv.state_dict_from_jax(model, state_j2.params,
                                       state_j2.batch_stats)
    for k, v in state.model.state_dict().items():
        close_rel(v, want_sd[k], k)
    adam = conv.adam_state(state_j2.opt_state)
    mu = conv.state_dict_from_jax(model, adam.mu, state_j2.batch_stats)
    nu = conv.state_dict_from_jax(model, adam.nu, state_j2.batch_stats)
    for name, p in state.model.named_parameters():
        st = state.optimizer.state[p]
        assert int(st["step"]) == int(adam.count)
        if name == "out_att.a" and not wd:
            continue
        close_rel(st["exp_avg"], mu[name], f"mu {name}")
        close_rel(st["exp_avg_sq"], nu[name], f"nu {name}")


def test_the_output_directory_is_required(data, capsys):
    _, data_dir = data
    assert conv.main(["--jax_checkpoint_dir", "x", "--data_dir",
                      data_dir]) == 2
    assert "--checkpoint_dir" in capsys.readouterr().err
