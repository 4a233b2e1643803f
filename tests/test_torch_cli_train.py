"""``cli train`` and ``cli eval`` of the port on the CPU, at a tiny size:
train writes a checkpoint that eval, predict and a train state read back;
what the port lacks exits 2, as the JAX CLI's refusals do.

The report's keys are the JAX CLI's (``msha_gnn_tpu/cli.py``); eval of
the checkpoint that training wrote gives the last epoch's report again
(the same model on the same held-out records), at rtol 1e-6.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from msha_gnn_torch import cli
from msha_gnn_torch.training import TrainState, restore_checkpoint
from msha_gnn_torch.utils import TrainConfig
from tests.test_torch_gcn import flow_arrays
from tests.test_torch_serving import write_data_dir

JAX_KEYS = ["epoch", "train_loss", "auc", "accuracy", "precision_macro",
            "recall_macro", "f1_macro", "precision_micro", "recall_micro",
            "f1_micro", "loss"]
SMALL = ["--in_features", "16", "--out_features", "8", "--batch_size", "16",
         "--seed", "3", "--device", "cpu"]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return write_data_dir(tmp_path_factory.mktemp("flow") / "data",
                          flow_arrays(4))


def last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("model", ["gcn", "msha", "ablation3"])
def test_train_then_eval_and_predict_read_the_checkpoint(
        data_dir, tmp_path, capsys, model):
    ckpt = str(tmp_path / "ckpt")
    args = ["--model", model, "--data_dir", data_dir, *SMALL]
    assert cli.main(["train", *args, "--epochs", "2",
                     "--checkpoint_dir", ckpt]) == 0
    trained = last_json(capsys.readouterr().out)
    assert list(trained) == JAX_KEYS and trained["epoch"] == 1
    assert all(np.isfinite(v) for v in trained.values())

    assert cli.main(["eval", *args, "--checkpoint_dir", ckpt]) == 0
    evaluated = last_json(capsys.readouterr().out)
    assert list(evaluated) == JAX_KEYS[2:] + ["checkpoint_step"]
    steps = 2 * -(-int(0.9 * 400) // 16)
    assert evaluated["checkpoint_step"] == steps
    for k in JAX_KEYS[2:]:
        np.testing.assert_allclose(evaluated[k], trained[k], rtol=1e-6,
                                   err_msg=k)

    assert cli.main(["predict", *args, "--checkpoint_dir", ckpt,
                     "--nodes", "0,1,2", "--top_k", "3"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(l)["node"] for l in lines[:3]] == [0, 1, 2]
    assert json.loads(lines[-1])["checkpoint_step"] == steps

    # the checkpoint restores a whole train state: model, Adam, step
    cfg = TrainConfig(model=model, in_features=16, out_features=8, seed=3)
    from msha_gnn_torch.data import load_flow_graph

    task, net = cli._build_task(cfg, load_flow_graph("2015", data_dir), "cpu")
    state, _, step = restore_checkpoint(
        ckpt, TrainState.create(net, task.optimizer))
    assert step == state.step == steps
    opt = state.optimizer.state_dict()["state"]
    assert len(opt) == len(list(net.parameters()))
    assert all(int(s["step"]) == steps for s in opt.values())


def test_train_runs_as_a_module(data_dir, tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "msha_gnn_torch.cli", "train", "--model",
         "gcn", "--epochs", "1", "--data_dir", data_dir, *SMALL],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert list(last_json(out.stdout)) == JAX_KEYS


def test_train_draws_its_dropout_from_the_seed(data_dir, capsys):
    """At dropout 0.5 two runs from one seed give the same record, another
    seed another (the masks come from the trainer's generator)."""
    args = ["train", "--model", "gcn", "--epochs", "1", "--data_dir",
            data_dir, *SMALL]
    runs = []
    for seed in ("3", "3", "4"):
        torch.manual_seed(int(seed) + 100)
        assert cli.main([*args, "--seed", seed]) == 0
        runs.append(last_json(capsys.readouterr().out))
    assert runs[0] == runs[1]
    assert runs[0]["train_loss"] != runs[2]["train_loss"]


@pytest.mark.parametrize("cmd", ["train", "eval"])
@pytest.mark.parametrize("model", ["gin", "sgc", "appnp"])
def test_unported_models_exit_2(data_dir, tmp_path, capsys, cmd, model):
    """A model that neither package has exits 2 (the port has every JAX
    preset)."""
    assert cli.main([cmd, "--model", model, "--data_dir", data_dir,
                     "--checkpoint_dir", str(tmp_path), "--device",
                     "cpu"]) == 2
    assert "not ported" in capsys.readouterr().err


def test_years_exits_2(data_dir, capsys):
    """``--years`` trains the MSHA family only (``training/temporal.py``;
    ``tests/test_torch_temporal.py`` holds the joint run itself)."""
    assert cli.main(["train", "--years", "2015,2016", "--model", "gcn",
                     "--data_dir", data_dir, "--device", "cpu"]) == 2
    assert "--years joint training supports the MSHA family only" in \
        capsys.readouterr().err


def test_a_year_without_flows_exits_2(tmp_path, capsys):
    d = write_data_dir(tmp_path / "data", flow_arrays(4), year="2016")
    os.remove(os.path.join(d, "Flow2016.csv"))
    assert cli.main(["train", "--year", "2016", "--data_dir", d,
                     "--device", "cpu"]) == 2
    assert "has no Flow records" in capsys.readouterr().err


def test_eval_needs_a_checkpoint(data_dir, tmp_path, capsys):
    assert cli.main(["eval", "--data_dir", data_dir, "--device",
                     "cpu"]) == 2
    assert "requires --checkpoint_dir" in capsys.readouterr().err
    assert cli.main(["eval", "--data_dir", data_dir, "--checkpoint_dir",
                     str(tmp_path / "none"), "--device", "cpu"]) == 2
    assert "no checkpoint" in capsys.readouterr().err
