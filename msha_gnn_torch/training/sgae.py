"""SGAE: graph-autoencoder embedding pretrain, then a GraphSAGE fine-tune
(``msha_gnn_tpu/training/sgae.py``, BASELINE config #2).

1. **Pretrain**: source embeddings ``z_src`` (GDP-seeded features) and
   recipient embeddings ``z_dst`` (U[0, 1)) decode the flow adjacency by
   an inner product, ``sigmoid(<z_i, z_r>)``, trained by BCE on observed
   records against uniform negative pairs.  The temporal form shares
   ``z_dst`` across years (the same 32 recipients) and keeps ``z_src`` per
   year; it interleaves the years' batches round-robin and skips a year
   with no records.
2. **Fine-tune**: GraphSAGE (:func:`~msha_gnn_torch.training.tasks.
   sage_task`) with ``Sfeatures`` set to the pretrained ``z_src``, through
   :meth:`~msha_gnn_torch.training.trainer.Trainer.fit`.

The numpy draws (permutations, negatives, the round-robin order) are the
JAX run's, from ``np.random.default_rng(seed)``.  An epoch's batches go to
the device at once and its losses are read once.  Adam steps every
embedding at every step, a year's ``z_src`` included when another year's
batch runs (zero gradient, the moments decaying), as optax does.  Plain
PyTorch: this pipeline reaches no Pallas kernel.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..data import load_flow_graph, train_test_split_records
from ..graph import FlowGraph
from ..models.common import features_with_gdp
from .losses import bce_loss
from .optim import adam_l2


def ae_loss(z_src: torch.Tensor, z_dst: torch.Tensor, pos_s, pos_r, neg_s,
            neg_r) -> torch.Tensor:
    """The inner-product decoder's BCE: the mean of the positives' and the
    negatives' ``sigmoid(<z_src[s], z_dst[r]>)`` losses."""
    pos = torch.sigmoid((z_src[pos_s] * z_dst[pos_r]).sum(-1))
    neg = torch.sigmoid((z_src[neg_s] * z_dst[neg_r]).sum(-1))
    return 0.5 * (bce_loss(pos, torch.ones_like(pos))
                  + bce_loss(neg, torch.zeros_like(neg)))


def pretrain_epoch_arrays(rng: np.random.Generator, src: np.ndarray,
                          dst: np.ndarray, n: int, m: int, batch_size: int,
                          neg_per_pos: int = 1):
    """One pretrain epoch's batches, drawn as the JAX run draws them: a
    permutation of the records, whole batches only, each followed by its
    negative sources in ``[0, n)`` and recipients in ``[0, m)``.  Returns
    ``(pos_s, pos_r)`` [S, B] and ``(neg_s, neg_r)`` [S, B * neg_per_pos]."""
    perm = rng.permutation(len(src))
    k = batch_size * neg_per_pos
    ids, neg_s, neg_r = [], [], []
    for i in range(0, len(perm) - batch_size + 1, batch_size):
        ids.append(perm[i: i + batch_size])
        neg_s.append(rng.integers(0, n, k))
        neg_r.append(rng.integers(0, m, k))
    ids = np.array(ids, np.int64).reshape(-1, batch_size)
    return (src[ids], dst[ids], np.array(neg_s, np.int64).reshape(-1, k),
            np.array(neg_r, np.int64).reshape(-1, k))


def temporal_epoch_schedule(rng: np.random.Generator, edges: dict,
                            n_src: dict, m: int, batch_size: int,
                            neg_per_pos: int = 1) -> list:
    """One temporal pretrain epoch's batches in the JAX run's round-robin
    order: a permutation per year (in ``edges``' order), then the years
    in turn, one whole batch each, a year leaving when it has no whole
    batch left.  Returns ``[(year, pos_s, pos_r, neg_s, neg_r), ...]``."""
    perms = {y: rng.permutation(len(edges[y][0])) for y in edges}
    offsets = {y: 0 for y in edges}
    k = batch_size * neg_per_pos
    out, live = [], list(edges)
    while live:
        for y in list(live):
            src, dst = edges[y]
            o = offsets[y]
            if o + batch_size > len(perms[y]):
                live.remove(y)
                continue
            ids = perms[y][o: o + batch_size]
            offsets[y] = o + batch_size
            out.append((y, src[ids], dst[ids], rng.integers(0, n_src[y], k),
                        rng.integers(0, m, k)))
    return out


def _adam_step(optimizer, params, loss: torch.Tensor) -> None:
    """One Adam step on ``loss`` over every one of ``params``: a parameter
    the loss does not read steps on a zero gradient, as optax steps the
    whole tree (torch's Adam skips a ``None`` gradient and keeps a step
    count per parameter)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        else:
            p.grad.zero_()
    loss.backward()
    optimizer.step()


def pretrain_autoencoder(fg: FlowGraph, *, dim: int = 32, epochs: int = 5,
                         batch_size: int = 4096, lr: float = 1e-3,
                         neg_per_pos: int = 1, seed: int = 42, log=None,
                         device="cuda"):
    """Returns ``(z_src [N, dim], z_dst [M, dim], loss_history)``, the
    embeddings on ``device``; each epoch's loss is the mean of its steps'."""
    log = log or (lambda r: None)
    dev = resolve_device(device)
    n, m = fg.n_src, fg.n_dst
    gen = torch.Generator().manual_seed(seed)
    z_src = features_with_gdp(n, dim, fg.gdp, gen).to(dev).requires_grad_()
    z_dst = torch.rand((m, dim), generator=gen).to(dev).requires_grad_()
    params = [z_src, z_dst]
    optimizer = adam_l2(params, lr)
    src, dst = fg.edge_src.numpy(), fg.edge_dst.numpy()
    rng = np.random.default_rng(seed)
    history = []
    for epoch in range(epochs):
        t0 = time.time()
        arrays = pretrain_epoch_arrays(rng, src, dst, n, m, batch_size,
                                       neg_per_pos)
        batches = [torch.from_numpy(a.astype(np.int64)).to(dev)
                   for a in arrays]
        losses = []
        for ps, pr, ns, nr in zip(*batches):
            loss = ae_loss(z_src, z_dst, ps, pr, ns, nr)
            _adam_step(optimizer, params, loss)
            losses.append(loss.detach())
        history.append(float(torch.stack(losses).double().sum())
                       / len(losses) if losses else 0.0)
        log({"event": "sgae_pretrain", "epoch": epoch, "loss": history[-1],
             "seconds": time.time() - t0})
    return z_src.detach(), z_dst.detach(), history


def pretrain_autoencoder_temporal(fgs: dict, *, dim: int = 32,
                                  epochs: int = 5, batch_size: int = 4096,
                                  lr: float = 1e-3, neg_per_pos: int = 1,
                                  seed: int = 42, log=None, device="cuda"):
    """Temporal multi-year pretrain over ``fgs`` (``{year: FlowGraph}``):
    ``z_dst`` shared (every year has the same recipients, else
    ValueError), ``z_src`` per year; a year with no records is skipped
    with a log line.  Returns ``(z_src_by_year, z_dst,
    loss_history_by_year)``."""
    log = log or (lambda r: None)
    dev = resolve_device(device)
    years = sorted(fgs)
    m_set = {fgs[y].n_dst for y in years}
    if len(m_set) != 1:
        raise ValueError(
            f"temporal pretrain needs a shared recipient set; got M={m_set}")
    m = m_set.pop()
    gen = torch.Generator().manual_seed(seed)
    z_dst = torch.rand((m, dim), generator=gen).to(dev).requires_grad_()
    z_src = {y: features_with_gdp(fgs[y].n_src, dim, fgs[y].gdp, gen)
             .to(dev).requires_grad_() for y in years}
    params = [z_dst, *z_src.values()]
    optimizer = adam_l2(params, lr)
    rng = np.random.default_rng(seed)
    active = []
    for y in years:
        if fgs[y].num_records == 0:
            log({"event": "sgae_temporal_skip_year", "year": y,
                 "reason": "no flow records"})
        else:
            active.append(y)
    history = {y: [] for y in active}
    edges = {y: (fgs[y].edge_src.numpy(), fgs[y].edge_dst.numpy())
             for y in active}
    n_src = {y: fgs[y].n_src for y in active}
    for epoch in range(epochs):
        t0 = time.time()
        losses = {y: [] for y in active}
        for y, *arrays in temporal_epoch_schedule(rng, edges, n_src, m,
                                                  batch_size, neg_per_pos):
            ps, pr, ns, nr = (torch.from_numpy(a.astype(np.int64)).to(dev)
                              for a in arrays)
            loss = ae_loss(z_src[y], z_dst, ps, pr, ns, nr)
            _adam_step(optimizer, params, loss)
            losses[y].append(loss.detach())
        for y in active:
            history[y].append(float(torch.stack(losses[y]).double().sum())
                              / len(losses[y]) if losses[y] else 0.0)
        log({"event": "sgae_temporal_pretrain", "epoch": epoch,
             "loss": {y: history[y][-1] for y in active},
             "seconds": time.time() - t0})
    return ({y: z.detach() for y, z in z_src.items()}, z_dst.detach(),
            history)


def _fit_sage(fg: FlowGraph, cfg, in_features: int, z_src, log, device):
    from .tasks import sage_task
    from .trainer import Trainer, TrainState

    task, model = sage_task(fg, in_features=in_features, dropout=cfg.dropout,
                            lr=cfg.lr, weight_decay=cfg.weight_decay,
                            seed=cfg.seed, device=device)
    if z_src is not None:
        with torch.no_grad():
            model.Sfeatures.copy_(z_src)
    train_ids, test_ids = train_test_split_records(fg.num_records, 0.9,
                                                   cfg.seed)
    state = TrainState.create(model, task.optimizer)
    trainer = Trainer(task=task, src=fg.edge_src.numpy(),
                      labels=fg.edge_dst.numpy(), batch_size=cfg.batch_size,
                      seed=cfg.seed, log=log)
    return trainer.fit(state, train_ids, test_ids, cfg.epochs)


def finetune_with_pretrained(fg: FlowGraph, z_src: torch.Tensor, cfg,
                             log=None, device="cuda"):
    """Fine-tune GraphSAGE with ``Sfeatures`` set to the pretrained
    embeddings ``z_src`` [N, d] (in place of its random init).  Returns
    ``(state, history)``."""
    return _fit_sage(fg, cfg, z_src.shape[1], z_src, log, device)


def run_sgae(cfg, log=None, fg: Optional[FlowGraph] = None,
             device="cuda") -> dict:
    """The config-#2 pipeline: the pretrain (temporal over ``cfg.years``
    when set, ``cfg.year`` always among them), then the fine-tune on
    ``cfg.year``.  Returns ``{"pretrain_loss", "finetune"}`` (the last
    epoch's record)."""
    log = log or (lambda r: None)
    if fg is None:
        fg = load_flow_graph(cfg.year, cfg.data_dir)
    years = [y for y in (cfg.years or "").split(",") if y]
    z_src, pre_hist = None, []
    if cfg.pretrain_epochs > 0 and years:
        fgs = {y: (fg if y == cfg.year else load_flow_graph(y, cfg.data_dir))
               for y in set(years) | {cfg.year}}
        z_by_year, _, pre_hist = pretrain_autoencoder_temporal(
            fgs, dim=cfg.in_features, epochs=cfg.pretrain_epochs, lr=cfg.lr,
            seed=cfg.seed, log=log, device=device)
        z_src = z_by_year[cfg.year]
    elif cfg.pretrain_epochs > 0:
        z_src, _, pre_hist = pretrain_autoencoder(
            fg, dim=cfg.in_features, epochs=cfg.pretrain_epochs, lr=cfg.lr,
            seed=cfg.seed, log=log, device=device)
    _, history = _fit_sage(fg, cfg, cfg.in_features, z_src, log, device)
    return {"pretrain_loss": pre_hist,
            "finetune": history[-1] if history else {}}
