"""Plain reference of full-graph GAT link prediction
(``gat-linkpred-ddi``), by autograd over the whole message graph.

The model: learnable ``features`` [n, h]; feature dropout; ``heads``
attention layers from ``h`` to ``h``, their outputs side by side;
dropout; one attention layer from ``heads h`` to ``h``.  A layer: ``x W``,
a logit an edge ``leaky_relu(c[s] + t[r])`` with ``c = x W a[:h]`` and
``t = x W a[h:]``, softmax over each sender's edges, the attention times
its edge's keep factor (dropout hashed from the layer's seed and the
edge's CSR slot), ``elu(sum att xW[r])``.  The predictor: the Hadamard
product of the two ends, ``predictor_layers - 1`` hidden linear layers
with relu and dropout, a linear output, sigmoid; the loss is half the sum
of the positives' and the negatives' mean BCE, the probabilities clipped
to ``[1e-7, 1 - 1e-7]``; Adam.

Worked out again here, from the benchmark's inputs: the message graph
(both directions of the train pairs, deduplicated) in CSR order, whose
position is the slot the keep factor hashes; the batches, from
``np.random.default_rng(seed)`` as ``link_prediction.epoch_batches``
draws them; the dropout draws, from a generator seeded alike on the same
device and drawn in the forward's order (the feature mask, a seed a head,
the hidden mask, the output layer's seed, the predictor's masks for the
positives and then the negatives); the keep factor by a frozen copy of
the repo's ``_hash01`` (a murmur3 finalizer on uint32).  Nothing of the
program is imported.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .common import matmul_precision, run_steps

M32 = 0xFFFFFFFF


def keep_scale(slots: np.ndarray, seed: int, rate: float) -> np.ndarray:
    """The inverted-dropout factor of each CSR slot under an int32 seed:
    ``1 / (1 - rate)`` (rounded to float32) where kept, 0 where dropped."""
    with np.errstate(over="ignore"):
        h = slots.astype(np.uint32) * np.uint32(0x9E3779B9) \
            + np.uint32(seed & M32)
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    u = (h & np.uint32(0xFFFFFF)).astype(np.float32) * np.float32(2.0 ** -24)
    scale = np.float32(1.0 / (1.0 - rate))
    return np.where(u >= np.float32(rate), scale, np.float32(0.0))


def message_graph(train: np.ndarray, n: int):
    """Senders and receivers (int64, host) of both directions of the
    train pairs, deduplicated, in (sender, receiver) order: the CSR
    order, so an edge's position is its slot."""
    s = np.concatenate([train[:, 0], train[:, 1]]).astype(np.int64)
    r = np.concatenate([train[:, 1], train[:, 0]]).astype(np.int64)
    key = np.unique(s * n + r)
    return key // n, key % n


def draw_batches(seed: int, train: np.ndarray, n: int, batch: int,
                 steps: int):
    """The first ``steps`` batches [4, batch] of the first epoch."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(train))
    per_epoch = len(perm) // batch
    ids = perm[: per_epoch * batch].reshape(per_epoch, batch)
    neg_s = rng.integers(0, n, (per_epoch, batch))
    neg_r = rng.integers(0, n, (per_epoch, batch))
    return [np.stack([train[ids[i], 0], train[ids[i], 1], neg_s[i],
                      neg_r[i]]) for i in range(steps)]


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator):
    keep = torch.rand(x.shape, generator=gen, device=gen.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def draw_seed(gen: torch.Generator) -> int:
    return int(torch.randint(-2**31, 2**31, (1,), generator=gen,
                             device=gen.device, dtype=torch.int64)
               .to(torch.int32))


def attention(x, W, a, graph, seed: int, rate: float, slope: float):
    s, r, slots = graph
    n, d = x.shape[0], W.shape[1]
    h = x @ W
    av = a.reshape(2 * d)
    u = (h @ av[:d])[s] + (h @ av[d:])[r]
    logit = F.leaky_relu(u, slope)
    top = torch.full((n,), -torch.inf, dtype=h.dtype, device=h.device)
    top = top.scatter_reduce(0, s, logit.detach(), "amax")
    w = torch.exp(logit - top[s])
    den = torch.zeros(n, dtype=h.dtype, device=h.device).index_add(0, s, w)
    att = w / den[s]
    keep = torch.from_numpy(keep_scale(slots, seed, rate)).to(h.device)
    att = att * keep.to(h.dtype)
    out = torch.zeros_like(h).index_add(0, s, att[:, None] * h[r])
    return F.elu(out)


def loss_and_grads(p: Dict[str, torch.Tensor], graph, batch: torch.Tensor,
                   model: dict, gen: torch.Generator):
    rate = float(model["dropout"])
    slope = 0.2
    heads = int(model["n_heads"])
    params = {k: v.requires_grad_() for k, v in p.items()}
    x = dropout(params["features"], rate, gen)
    hs = []
    for i in range(heads):
        pre = f"encoder.attention_{i}."
        hs.append(attention(x, params[pre + "W"], params[pre + "a"], graph,
                            draw_seed(gen), rate, slope))
    hcat = dropout(torch.cat(hs, 1), rate, gen)
    z = attention(hcat, params["encoder.out_att.W"],
                  params["encoder.out_att.a"], graph, draw_seed(gen), rate,
                  slope)
    n_lin = int(model["num_layers"])

    def predict(i, j):
        y = z[i] * z[j]
        for k in range(n_lin - 1):
            y = dropout(torch.relu(F.linear(
                y, params[f"predictor.lins.{k}.weight"],
                params[f"predictor.lins.{k}.bias"])), rate, gen)
        y = F.linear(y, params[f"predictor.lins.{n_lin - 1}.weight"],
                     params[f"predictor.lins.{n_lin - 1}.bias"])[..., 0]
        return torch.sigmoid(y)

    def bce(scores, target):
        sc = scores.clamp(1e-7, 1.0 - 1e-7)
        return -(target * torch.log(sc)
                 + (1.0 - target) * torch.log(1.0 - sc)).mean()

    pos = predict(batch[0], batch[1])
    neg = predict(batch[2], batch[3])
    loss = 0.5 * (bce(pos, 1.0) + bce(neg, 0.0))
    names = list(params)
    grads = torch.autograd.grad(loss, [params[k] for k in names])
    return loss.detach(), dict(zip(names, grads))


def run(inputs: dict, params0: Dict[str, torch.Tensor], model: dict,
        batch: int, steps: int, *, dtype=torch.float64, tf32: bool = False,
        device="cuda", batch_hook: Optional[Callable] = None) -> Dict:
    """Readings of ``steps`` steps from ``params0`` on the benchmark's
    train pairs (``inputs["train"]``, host [m, 2])."""
    n = int(inputs["nodes"])
    train = np.asarray(inputs["train"])
    s, r = message_graph(train, n)
    slots = np.arange(len(s))
    graph = (torch.from_numpy(s).to(device), torch.from_numpy(r).to(device),
             slots)
    batches = [torch.from_numpy(b).to(device) for b in
               draw_batches(inputs["model_seed"], train, n, batch, steps)]
    if batch_hook is not None:
        batches = [batch_hook(b) for b in batches]
    gen = torch.Generator(device=device).manual_seed(inputs["model_seed"])

    def step(params, i):
        return loss_and_grads(params, graph, batches[i], model, gen)

    with matmul_precision(tf32):
        return run_steps(params0, steps, float(model["lr"]), step, dtype)
