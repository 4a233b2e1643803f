"""What the plain references share: Adam and the readings a run of a few
steps gives.  Plain PyTorch; nothing of the program."""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Dict, List

import torch

BETAS = (0.9, 0.999)
EPS = 1e-8


@contextmanager
def matmul_precision(tf32: bool):
    """Float32 GEMMs in TF32 (the control) or in full float32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def run_steps(params0: Dict[str, torch.Tensor], steps: int, lr: float,
              loss_and_grads: Callable, dtype) -> Dict:
    """``steps`` Adam steps (``torch.optim.Adam``'s update, written out)
    from ``params0`` cast to ``dtype``; ``loss_and_grads(params, i)`` gives
    step ``i``'s loss (a float) and gradients.  Returns the losses, the
    first step's gradient norm a leaf and each leaf's change after the
    first step and after the last."""
    params = {k: v.detach().to(dtype).clone() for k, v in params0.items()}
    start = {k: v.clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    b1, b2 = BETAS
    for i in range(steps):
        loss, grads = loss_and_grads(params, i)
        losses.append(float(loss))
        if i == 0:
            grad_norms = {k: float(g.norm()) for k, g in grads.items()}
        t = i + 1
        with torch.no_grad():
            for k, g in grads.items():
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k].sqrt() / (1 - b2 ** t) ** 0.5).add_(EPS)
                params[k].addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
        del grads
        changes = {k: float((params[k].detach() - start[k]).norm())
                   for k in params}
        if i == 0:
            first = changes
    return {"losses": losses, "grad_norms": grad_norms,
            "first_change_norms": first, "change_norms": changes}
