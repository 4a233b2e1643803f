"""Carry a JAX package checkpoint into the PyTorch port.

    python scripts_torch_convert_checkpoint.py --jax_checkpoint_dir JAX_CKPT \
        --checkpoint_dir OUT [--model msha --data_dir DATA --in_features ...]

Restores an orbax checkpoint written by
``msha_gnn_tpu/training/checkpoint.py`` (``cli train --checkpoint_dir``)
into the JAX ``cli._build_task`` template of the same flags, and writes
the port's checkpoint layout (``msha_gnn_torch/training/checkpoint.py``)
for the same model: ``cli eval``, ``cli predict``, ``cli serve`` and
``cli export`` of the port then read ``OUT``.

* The parameters and ``batch_stats`` go through the model's
  ``*_params_from_jax`` (``msha_gnn_torch/models/convert.py``).
* Adam's moments ``mu`` and ``nu`` share the parameters' tree, so they go
  through the same function, and become each parameter's ``exp_avg`` and
  ``exp_avg_sq``.  optax keeps one ``count``; ``torch.optim.Adam`` keeps a
  ``step`` a parameter, and each gets the count.  The
  ``add_decayed_weights`` state (empty) is dropped: with weight decay the
  optimiser state is a chain, at ``weight_decay=0`` the Adam state alone,
  and both are read.

The flags must be the ones the JAX run trained with (the shapes follow
them).  The script imports both packages, so it runs where JAX is
installed; the port itself never imports JAX.  Prints a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

MSHA_PRESETS = ("msha", "ours", "ablation1", "ablation2", "ablation3")


def adam_state(opt_state):
    """optax's ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) inside a
    chain's state, or the state itself."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            found = adam_state(part)
            if found is not None:
                return found
    return None


def state_dict_from_jax(model: str, params, batch_stats) -> dict:
    """The port's ``state_dict`` of ``model`` from a flax ``params`` tree
    (or a tree shaped like it) and ``batch_stats``."""
    from msha_gnn_torch.models import (gat_params_from_jax,
                                       gcn_params_from_jax,
                                       hgane_params_from_jax,
                                       msha_params_from_jax,
                                       sage_params_from_jax)

    convert = {"gcn": gcn_params_from_jax, "gat": gat_params_from_jax,
               "sage": sage_params_from_jax, "hgane": hgane_params_from_jax,
               **dict.fromkeys(MSHA_PRESETS, msha_params_from_jax)}
    if model not in convert:
        raise ValueError(f"model {model!r} has no converter")
    return convert[model]({"params": params, "batch_stats": batch_stats})


def convert(cfg, jax_checkpoint_dir: str, checkpoint_dir: str) -> dict:
    """Restore ``jax_checkpoint_dir`` for ``cfg`` and write the port's
    checkpoint of the same step to ``checkpoint_dir``."""
    from msha_gnn_tpu import cli as jax_cli
    from msha_gnn_tpu.data import load_flow_graph as jax_load_flow_graph
    from msha_gnn_tpu.training import TrainState as JaxTrainState
    from msha_gnn_tpu.training.checkpoint import \
        restore_checkpoint as jax_restore_checkpoint
    from msha_gnn_torch import cli
    from msha_gnn_torch.data import load_flow_graph
    from msha_gnn_torch.training import TrainState, save_checkpoint

    built = jax_cli._build_task(cfg, jax_load_flow_graph(cfg.year,
                                                         cfg.data_dir))
    if built is None:
        raise ValueError(f"unknown model {cfg.model!r}")
    task_j, variables = built
    state_j, extra, step = jax_restore_checkpoint(
        jax_checkpoint_dir, JaxTrainState.create(variables, task_j.tx))

    task, model = cli._build_task(cfg, load_flow_graph(cfg.year,
                                                       cfg.data_dir), "cpu")
    model.load_state_dict(state_dict_from_jax(cfg.model, state_j.params,
                                              state_j.batch_stats))
    state = TrainState.create(model, task.optimizer)
    state.step = int(state_j.step)
    adam = adam_state(state_j.opt_state)
    if adam is None:
        raise ValueError("the JAX optimiser state holds no Adam moments")
    mu = state_dict_from_jax(cfg.model, adam.mu, state_j.batch_stats)
    nu = state_dict_from_jax(cfg.model, adam.nu, state_j.batch_stats)
    count = float(adam.count)
    for name, p in model.named_parameters():
        state.optimizer.state[p] = {
            "step": torch.tensor(count),
            "exp_avg": mu[name].reshape(p.shape).clone(),
            "exp_avg_sq": nu[name].reshape(p.shape).clone()}
    save_checkpoint(checkpoint_dir, state, step=int(step), extra=extra)
    return {"checkpoint_dir": checkpoint_dir, "step": int(step),
            "model": cfg.model, "adam_count": int(count),
            "parameters": len(list(model.parameters()))}


def main(argv=None) -> int:
    from msha_gnn_torch.cli import _add_dataclass_args, _config_from_args
    from msha_gnn_torch.utils import TrainConfig

    parser = argparse.ArgumentParser(
        prog="scripts_torch_convert_checkpoint",
        description="a JAX (orbax) checkpoint -> the port's checkpoint")
    parser.add_argument("--jax_checkpoint_dir", required=True)
    _add_dataclass_args(parser, TrainConfig)
    args = parser.parse_args(argv)
    cfg = _config_from_args(TrainConfig, args)
    if not cfg.checkpoint_dir:
        print("--checkpoint_dir (the port's output) is required",
              file=sys.stderr)
        return 2
    print(json.dumps(convert(cfg, args.jax_checkpoint_dir,
                             cfg.checkpoint_dir)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
