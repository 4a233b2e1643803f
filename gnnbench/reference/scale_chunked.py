"""Plain reference of the out-of-core rank-1 GAT link predictor
(``gat-scale-d32``), in blocks of edges so that 50 M edges fit.

The model: ``h = feat W``; a logit an edge ``leaky_relu(c[s] + t[r])``
with ``c = h a[:d]``, ``t = h a[d:]``; softmax over each sender's edges;
``agg[s] = sum att h[r]``; ``z = elu(agg) + h``; BCE with logits of
``<z[s], z[r]>`` on the batch's positive (label 1) and negative (label 0)
pairs, the two means added; Adam.

The forward takes three passes over the edge blocks (row maxima, the
softmax's denominators, the aggregation).  The loss's gradient with
respect to ``agg`` and ``h`` comes from autograd over ``[N, d]`` tensors;
the attention's backward is written out and takes one more pass:
``dh[r] += att dagg[s]``, ``datt = <dagg[s], h[r]>``, ``dl = att (datt -
<dagg[s], agg[s]>)``, ``du = dl`` where ``u > 0`` and ``slope dl``
elsewhere, ``dc[s] += du``, ``dt[r] += du``; then ``dh += dc a[:d]^T + dt
a[d:]^T``, ``da = [h^T dc, h^T dt]``, ``dW = feat^T dh``, ``dfeat = dh
W^T``.  The sender order is worked out again (a stable sort), and the
batches are drawn again from the batch seed as ``scale.draw_batch`` draws
them.  Nothing of the program is imported.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .common import matmul_precision, run_steps

BLOCK = 1 << 22


def draw_batches(batch_seed: int, senders: torch.Tensor,
                 receivers: torch.Tensor, n: int, batch: int, steps: int):
    """The first ``steps`` batches ``(pos_s, pos_r, neg_s, neg_r)``: from
    ``np.random.default_rng(batch_seed)`` a step, ``batch`` edge ids into
    the sender-ordered edges, then ``batch`` negative senders and
    receivers uniform over the nodes."""
    rng = np.random.default_rng(batch_seed)
    out = []
    for _ in range(steps):
        ids = torch.from_numpy(rng.integers(0, senders.numel(), batch))
        neg = [torch.from_numpy(rng.integers(0, n, batch, dtype=np.int64))
               for _ in range(2)]
        ids = ids.to(senders.device)
        out.append((senders[ids], receivers[ids],
                    *(v.to(senders.device) for v in neg)))
    return out


def loss_and_grads(p: Dict[str, torch.Tensor], s: torch.Tensor,
                   r: torch.Tensor, n: int, batch, slope: float,
                   block: int = BLOCK):
    feat, W, a = p["feat"], p["W"], p["a"]
    d = W.shape[0]
    h = feat @ W
    c, t = h @ a[:d], h @ a[d:]
    blocks = [(lo, min(lo + block, s.numel()))
              for lo in range(0, s.numel(), block)]

    def logits(lo, hi):
        sb, rb = s[lo:hi], r[lo:hi]
        u = c[sb] + t[rb]
        return sb, rb, u, F.leaky_relu(u, slope)

    m = torch.full((n,), -torch.inf, dtype=h.dtype, device=h.device)
    for lo, hi in blocks:
        sb, _, _, l = logits(lo, hi)
        m.scatter_reduce_(0, sb, l, "amax")
    den = torch.zeros(n, dtype=h.dtype, device=h.device)
    agg = torch.zeros_like(h)
    for lo, hi in blocks:
        sb, rb, _, l = logits(lo, hi)
        w = torch.exp(l - m[sb])
        den.index_add_(0, sb, w)
        agg.index_add_(0, sb, w[:, None] * h[rb])
    den_safe = torch.where(den > 0, den, torch.ones_like(den))
    agg = agg / den_safe[:, None]

    agg_l = agg.clone().requires_grad_()
    h_l = h.clone().requires_grad_()
    z = F.elu(agg_l) + h_l
    pos_s, pos_r, neg_s, neg_r = batch
    pos = (z[pos_s] * z[pos_r]).sum(1)
    neg = (z[neg_s] * z[neg_r]).sum(1)
    loss = (F.binary_cross_entropy_with_logits(pos, torch.ones_like(pos))
            + F.binary_cross_entropy_with_logits(neg, torch.zeros_like(neg)))
    dagg, dh = torch.autograd.grad(loss, (agg_l, h_l))

    gsum = (dagg * agg).sum(1)
    dc = torch.zeros_like(c)
    dt = torch.zeros_like(t)
    for lo, hi in blocks:
        sb, rb, u, l = logits(lo, hi)
        att = torch.exp(l - m[sb]) / den_safe[sb]
        g = dagg[sb]
        dh.index_add_(0, rb, att[:, None] * g)
        dl = att * ((g * h[rb]).sum(1) - gsum[sb])
        du = torch.where(u > 0, dl, dl * slope)
        dc.index_add_(0, sb, du)
        dt.index_add_(0, rb, du)
    dh += dc[:, None] * a[:d] + dt[:, None] * a[d:]
    grads = {"feat": dh @ W.T, "W": feat.T @ dh,
             "a": torch.cat([h.T @ dc, h.T @ dt])}
    return loss.detach(), grads


def run(inputs: dict, params0: Dict[str, torch.Tensor], model: dict,
        batch: int, steps: int, *, dtype=torch.float64, tf32: bool = False,
        device="cuda", batch_hook: Optional[Callable] = None) -> Dict:
    """Readings of ``steps`` steps from ``params0`` on the benchmark's
    edges (``inputs["senders"]``, ``["receivers"]``, host arrays)."""
    s = torch.from_numpy(np.asarray(inputs["senders"])).to(device).long()
    r = torch.from_numpy(np.asarray(inputs["receivers"])).to(device).long()
    order = torch.sort(s, stable=True).indices
    s, r = s[order], r[order]
    del order
    n = int(inputs["nodes"])
    batches = draw_batches(inputs["batch_seed"], s, r, n, batch, steps)
    if batch_hook is not None:
        batches = [batch_hook(b) for b in batches]
    slope = float(model["negative_slope"])

    def step(params, i):
        return loss_and_grads(params, s, r, n, batches[i], slope)

    with matmul_precision(tf32):
        return run_steps(params0, steps, float(model["lr"]), step, dtype)
