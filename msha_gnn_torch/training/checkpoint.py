"""Checkpoints of a model or a train state (``msha_gnn_tpu/training/
checkpoint.py``, with ``torch.save`` in place of orbax).

Layout: ``<directory>/step_<n>/state.pt`` holds ``{"step", "state_dict"}``
and, for a :class:`~.trainer.TrainState`, ``"optimizer"`` (the
optimiser's ``state_dict``), with every tensor on the CPU, and
``<directory>/extra_<n>.json`` the optional extra dict.  The model's
``state_dict`` sits under the same key either way, so a checkpoint that
training writes restores into a bare model for serving.  The newest
``max_to_keep`` steps are kept.  Reading the JAX package's orbax
checkpoints is not supported yet.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Mapping, Optional, Union

import torch
from torch import nn

from .trainer import TrainState

_STEP_DIR = re.compile(r"^step_(\d+)$")


def _steps(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_DIR.match,
                                                os.listdir(directory)) if m)


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(directory: str,
                    state: Union[TrainState, nn.Module, Mapping],
                    step: int, extra: Optional[dict] = None,
                    max_to_keep: int = 3) -> None:
    """Write ``state`` (a train state, a module or a state dict) as step
    ``step``."""
    payload = {"step": int(step)}
    if isinstance(state, TrainState):
        payload["optimizer"] = _to_cpu(state.optimizer.state_dict())
        state = state.model
    sd = state.state_dict() if isinstance(state, nn.Module) else state
    payload["state_dict"] = _to_cpu(dict(sd))
    step_dir = os.path.join(os.path.abspath(directory), f"step_{int(step)}")
    os.makedirs(step_dir, exist_ok=True)
    path = os.path.join(step_dir, "state.pt")
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    if extra is not None:
        with open(os.path.join(os.path.abspath(directory),
                               f"extra_{int(step)}.json"), "w") as f:
            json.dump(extra, f)
    for old in _steps(directory)[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, f"step_{old}"))


def restore_checkpoint(directory: str,
                       template: Union[TrainState, nn.Module],
                       step: Optional[int] = None):
    """Load step ``step`` (default: the latest) into ``template``, on the
    template's device: a module's ``state_dict``, or a train state's model,
    optimiser (when the checkpoint holds one) and step.  Returns
    ``(template, extra, step)``."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(os.path.abspath(directory), f"step_{int(step)}",
                        "state.pt")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(template, TrainState):
        template.model.load_state_dict(ckpt["state_dict"])
        if "optimizer" in ckpt:
            template.optimizer.load_state_dict(ckpt["optimizer"])
        template.step = int(ckpt["step"])
    else:
        template.load_state_dict(ckpt["state_dict"])
    extra = None
    extra_path = os.path.join(os.path.abspath(directory),
                              f"extra_{int(step)}.json")
    if os.path.exists(extra_path):
        with open(extra_path) as f:
            extra = json.load(f)
    return template, extra, int(ckpt["step"])


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None
