"""Link prediction at ogbl-ddi scale: a SparseGAT encoder and a
LinkPredictor trained with BCE on train-edge positives and uniform
negatives, evaluated by OGB Hits@K and AUC
(``msha_gnn_tpu/training/link_prediction.py``).

On CUDA ``impl="auto"`` resolves to ``"fused"``: every ``SparseGATLayer``
runs the hand-written rank-1 GAT kernels, attention dropout included.  On
the CPU it resolves to ``"torch"``, the plain path.  Training is a plain
loop of steps (:func:`train_step`); the JAX package's ``lax.scan`` over an
epoch is a dispatch device of its own and has no counterpart here.  The
numpy draws (batch order, negatives) are the JAX package's, so one seed
gives both the same batches.  Evaluation encodes the graph once and scores
every pair from that encoding.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..graph import BipartiteGraph
from ..models import LinkPredictor, SparseGAT
from ..models.gat import resolve_impl
from .losses import bce_loss
from .metrics import binary_auc, hits_at_k
from .optim import adam_l2


@dataclasses.dataclass
class LinkPredConfig:
    hidden: int = 64
    n_heads: int = 2
    num_layers: int = 2
    dropout: float = 0.5
    lr: float = 5e-3
    epochs: int = 10
    batch_size: int = 4096
    predictor: str = "mlp"
    neighbor_fanout: int = 0      # 0 = full graph; > 0 is not ported
    use_kd: bool = False          # not ported (nor its weights)
    seed: int = 42
    impl: str = "auto"            # auto | torch | fused


class LinkPredModel(nn.Module):
    """The learnable ``features`` [n, hidden] (N(0, 0.1^2)), the encoder
    and the predictor: the ``{"features", "encoder", "predictor"}`` tree of
    the JAX run, as one module."""

    def __init__(self, n: int, cfg: LinkPredConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = nn.Parameter(
            torch.randn((n, cfg.hidden), generator=generator) * 0.1)
        self.encoder = SparseGAT(cfg.hidden, cfg.hidden, cfg.hidden,
                                 n_heads=cfg.n_heads, dropout=cfg.dropout,
                                 generator=generator)
        self.predictor = LinkPredictor(cfg.predictor, cfg.hidden,
                                       num_layers=cfg.num_layers,
                                       dropout=cfg.dropout,
                                       generator=generator)

    def encode(self, graph: BipartiteGraph, *, train: bool, impl: str,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.encoder(graph, self.features, train=train, impl=impl,
                            generator=generator)


def linkpred_loss(model: LinkPredModel, graph: BipartiteGraph, batch, *,
                  impl: str, generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """The training loss of one batch ``(pos_s, pos_r, neg_s, neg_r)``:
    the mean of the positives' and the negatives' BCE."""
    pos_s, pos_r, neg_s, neg_r = batch
    h = model.encode(graph, train=True, impl=impl, generator=generator)
    pos = model.predictor(h[pos_s], h[pos_r], train=True, generator=generator)
    neg = model.predictor(h[neg_s], h[neg_r], train=True, generator=generator)
    return 0.5 * (bce_loss(pos, torch.ones_like(pos))
                  + bce_loss(neg, torch.zeros_like(neg)))


@dataclasses.dataclass
class LinkPredRun:
    """Everything one training run holds: the message graph on the device,
    the model, the optimiser, the dropout generator (on the device) and
    the numpy generator of the batches."""

    cfg: LinkPredConfig
    split: dict
    graph: BipartiteGraph
    model: LinkPredModel
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    rng: np.random.Generator
    impl: str
    device: torch.device


def build_link_prediction(split, cfg: LinkPredConfig,
                          device="cuda") -> LinkPredRun:
    """Set-up of a run: the model initialised from ``cfg.seed`` (on the
    CPU, then moved), Adam, and, for ``impl="fused"``, the graph's
    operators built once."""
    dev = resolve_device(device)
    if cfg.neighbor_fanout > 0:
        raise NotImplementedError(
            "neighbor_fanout > 0 needs data/sampler.py, not ported yet "
            "(ROADMAP queue 1 item 4)")
    if cfg.use_kd:
        raise NotImplementedError(
            "use_kd needs the KD student loop of training/kd.py, not ported "
            "yet (ROADMAP queue 1 item 8)")
    impl = resolve_impl(cfg.impl, dev)
    graph = split["graph"].to(dev)
    model = LinkPredModel(split["n"], cfg,
                          generator=torch.Generator().manual_seed(cfg.seed))
    model = model.to(dev)
    if impl == "fused":
        from ..ops.cuda.spmm import operator_for

        operator_for(graph)  # the CSR/CSC build is set-up, not a step
    return LinkPredRun(
        cfg=cfg, split=split, graph=graph, model=model,
        optimizer=adam_l2(model.parameters(), cfg.lr),
        generator=torch.Generator(device=dev).manual_seed(cfg.seed),
        rng=np.random.default_rng(cfg.seed), impl=impl, device=dev)


def epoch_batches(run: LinkPredRun) -> torch.Tensor:
    """One epoch's batches on the device, [steps, 4, batch]: a permutation
    of the train positives (remainder dropped) and uniform negatives, drawn
    from the run's numpy generator as the JAX run draws them."""
    train_s, train_r = run.split["train_pos"]
    b = run.cfg.batch_size
    perm = run.rng.permutation(len(train_s))
    steps = len(perm) // b
    if steps == 0:
        raise ValueError(f"batch_size {b} exceeds the {len(perm)} train "
                         "edges")
    ids = perm[: steps * b].reshape(steps, b)
    neg_s = run.rng.integers(0, run.split["n"], (steps, b))
    neg_r = run.rng.integers(0, run.split["n"], (steps, b))
    batches = np.stack([train_s[ids], train_r[ids], neg_s, neg_r], axis=1)
    return torch.from_numpy(batches.astype(np.int64)).to(run.device)


def train_step(run: LinkPredRun, batch: torch.Tensor) -> torch.Tensor:
    """One optimiser step on ``batch`` [4, B]; returns the loss (on the
    device, not synchronised)."""
    run.optimizer.zero_grad(set_to_none=True)
    loss = linkpred_loss(run.model, run.graph, batch, impl=run.impl,
                         generator=run.generator)
    loss.backward()
    run.optimizer.step()
    return loss.detach()


@torch.no_grad()
def evaluate(run: LinkPredRun, batch_size: int = 65536) -> dict:
    """Hits@20, Hits@50 and AUC of the test positives against the fixed
    negatives, from one encoding of the graph."""
    model = run.model
    h = model.encode(run.graph, train=False, impl=run.impl)

    def scores(s_idx, r_idx):
        s = torch.from_numpy(np.asarray(s_idx, np.int64)).to(run.device)
        r = torch.from_numpy(np.asarray(r_idx, np.int64)).to(run.device)
        return torch.cat([
            model.predictor(h[s[i:i + batch_size]], h[r[i:i + batch_size]],
                            train=False)
            for i in range(0, len(s), batch_size)])

    pos = scores(*run.split["test_pos"])
    neg = scores(*run.split["neg"])
    return {
        "hits@20": float(hits_at_k(pos, neg, 20)),
        "hits@50": float(hits_at_k(pos, neg, 50)),
        "auc": binary_auc(pos.cpu().numpy(), neg.cpu().numpy()),
    }


def run_link_prediction(split, cfg: LinkPredConfig, log=None,
                        device="cuda") -> dict:
    """Train and evaluate on a :func:`msha_gnn_torch.data.split_edges`
    split.  Returns ``{"hits@20", "hits@50", "auc", "final_train_loss",
    "impl", "dataset"}``."""
    log = log or (lambda r: None)
    run = build_link_prediction(split, cfg, device)
    history = []
    for epoch in range(cfg.epochs):
        t0 = time.time()
        losses = [train_step(run, batch) for batch in epoch_batches(run)]
        losses = torch.stack(losses)
        history.append(float(losses.mean()))
        log({"event": "linkpred_epoch", "epoch": epoch, "loss": history[-1],
             "seconds": time.time() - t0, "label": float(losses[-1])})
    result = {
        **evaluate(run),
        "final_train_loss": history[-1] if history else float("nan"),
        "impl": run.impl,
        "dataset": split["name"],
    }
    log({"event": "linkpred_eval", **result})
    return result
