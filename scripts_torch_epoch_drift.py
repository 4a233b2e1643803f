"""How far the linkpred training ways drift apart over one epoch, on one
CUDA card.

    python3 scripts_torch_epoch_drift.py

At ``LinkPredConfig()`` (hidden 64, 2 heads, dropout 0.5, batch 4096) on
synthetic ogbl-ddi (seed 42), one epoch of 40 steps of each run below, all
from the same initial weights, batches and dropout masks:

* ``plain64``: the plain path (``impl="torch"``) with the model in float64,
  the reference trajectory;
* ``plain32`` and ``plain32b``: the plain path in float32, twice.  Its
  ``index_add_`` adds by atomics, so the two differ only in the order of
  their float32 sums;
* ``fused``, ``materialised`` and ``flash`` in float32.

For each float32 run it prints each step's loss against ``plain64`` and
against ``fused`` (relative error at steps 0, 1, 5, 10, 20, 39 and the
largest over the epoch), and the first step's gradients against
``plain64`` (over the leaves, the largest of max |diff| / max |value|).
Prints the card's name and power limit first and one JSON summary last.
Needs CUDA; exits 1 without it.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

RUNS = (("plain64", "torch", torch.float64), ("plain32", "torch", None),
        ("plain32b", "torch", None), ("fused", "auto", None),
        ("materialised", "materialised", None), ("flash", "flash", None))
SHOWN_STEPS = (0, 1, 5, 10, 20, 39)


def epoch(split, impl: str, dtype) -> tuple[list, dict]:
    """One epoch's step losses and the first step's gradients."""
    from msha_gnn_torch.training import (LinkPredConfig,
                                         build_link_prediction, train_step)
    from msha_gnn_torch.training.link_prediction import epoch_batches

    run = build_link_prediction(split, LinkPredConfig(impl=impl),
                                device="cuda")
    if dtype is not None:
        run.model.to(dtype)  # in place: Adam keeps the same parameters
    losses, grads = [], None
    for batch in epoch_batches(run):
        losses.append(train_step(run, batch))
        if grads is None:
            grads = {k: p.grad.double().clone()
                     for k, p in run.model.named_parameters()}
    return [float(v) for v in torch.stack(losses).double().cpu()], grads


def rel(a: list, b: list) -> list:
    return [abs(x - y) / abs(y) for x, y in zip(a, b)]


def main() -> int:
    if not torch.cuda.is_available():
        print("scripts_torch_epoch_drift: CUDA is not available",
              file=sys.stderr)
        return 1
    from msha_gnn_torch.data import load_ddi, split_edges

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    split = split_edges(load_ddi(seed=42), seed=42)
    losses, grads = {}, {}
    for name, impl, dtype in RUNS:
        losses[name], grads[name] = epoch(split, impl, dtype)
    ref, summary = losses["plain64"], {}
    shown = [i for i in SHOWN_STEPS if i < len(ref)]
    for name in losses:
        if name == "plain64":
            continue
        vs64, vs_fused = rel(losses[name], ref), rel(losses[name],
                                                     losses["fused"])
        grad_err = max(
            float((g - grads["plain64"][k]).abs().max()
                  / grads["plain64"][k].abs().max())
            for k, g in grads[name].items())
        summary[name] = {
            "vs_plain64_at_steps": [vs64[i] for i in shown],
            "vs_plain64_max": max(vs64),
            "vs_fused_at_steps": [vs_fused[i] for i in shown],
            "vs_fused_max": max(vs_fused),
            "step0_grad_err_vs_plain64": grad_err,
        }
        print(f"{name:>12}: loss vs plain64, steps {shown}: "
              + " ".join(f"{v:.2e}" for v in summary[name]
                         ["vs_plain64_at_steps"])
              + f", max {max(vs64):.2e}; vs fused max {max(vs_fused):.2e}; "
              f"step-0 gradients vs plain64 {grad_err:.2e}", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "steps": len(ref), "plain64_losses": ref,
                      "runs": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
