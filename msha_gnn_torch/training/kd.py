"""LLP: knowledge-distilled MLP link prediction on the flow graph
(``msha_gnn_tpu/training/kd.py``, the reference's ``LLP.py``).

A structure-free MLP student scores (source, recipient) pairs while it is
distilled from a frozen dense GAT teacher that sees the flow graph: loss
``true_label * label + kd_f * (1 - cos(h_s, h_t)) + kd_p * mse(score_s,
score_t)``, plus ``kd_rank`` times a margin-rank term.  The JAX module's
repaired-intent notes hold here as well:

* the label loss is the BCE of positive records against recipient
  negatives, every term a weighted mean over the batch (the last partial
  batch padded at weight 0); ``ps_samples > 0`` adds pairs from the 'nb' /
  'rw' positive samplers that carry only the KD terms (label weight 0);
* the features are ``rand + GDP column``, drawn once a run;
* the teacher is frozen, so its full-graph embedding is computed once;
* the student is row-local (no norm), so a step encodes only the ``3B``
  rows its losses read;
* ``eval_mode="link"``: AUC and Hits@K of held-out records against
  recipient negatives in ``[0, M)``; ``"multiclass"``: the reference's
  ``test()``, the predictor's ``[B, hidden]`` output scored as recipient
  classes; ``val_fraction`` / ``eval_steps`` / ``patience`` with the best
  state restored.

The numpy draws (the epoch's sampled pairs, permutation and negatives, the
evaluation's negatives) are the JAX run's, from ``np.random.default_rng(
seed)``.  An epoch's batches go to the device at once; its losses are read
once an epoch.  Plain PyTorch: this pipeline reaches no Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..data import load_flow_graph, train_test_split_records
from ..data.sampler import (sample_negatives, sample_positives_nearby,
                            sample_positives_rw)
from ..graph import FlowGraph
from ..models import GAT, MLP, LinkPredictor
from ..models.common import features_with_gdp
from .metrics import binary_auc, classification_report, hits_at_k
from .optim import adam_l2


def check_llp_config(cfg, m: int) -> None:
    """The JAX run's guards: the cosine term compares the student's
    ``hidden_channels`` wide rows with the teacher's M wide ones, and the
    two evaluation modes each need their predictor."""
    d = cfg.hidden_channels
    if cfg.kd_f > 0.0 and d != m:
        raise ValueError(
            f"kd_f > 0 requires hidden_channels == n_dst ({m}); got {d}. "
            "Set hidden_channels to the recipient count or kd_f=0.")
    if cfg.eval_mode == "multiclass":
        if cfg.final_linear:
            raise ValueError(
                "eval_mode='multiclass' reproduces the reference's test(), "
                "which scores the predictor's (B, hidden) output as "
                "recipient classes: set final_linear=False.")
        if cfg.predictor != "mlp":
            raise ValueError(
                "eval_mode='multiclass' needs the 'mlp' predictor's "
                "(B, hidden) output; 'inner' emits scalars.")
        if d != m:
            raise ValueError(
                f"eval_mode='multiclass' needs hidden_channels == n_dst "
                f"({m}); got {d}.")
        if cfg.metric.startswith("hits"):
            raise ValueError(
                "eval_mode='multiclass' reports classification metrics "
                "(auc, accuracy, f1_macro, ...): Hits@K is undefined "
                f"there; set --metric accordingly (got {cfg.metric!r}).")
    elif cfg.eval_mode == "link":
        if not cfg.final_linear:
            raise ValueError(
                "final_linear=False makes the predictor emit (B, hidden) "
                "matrices, which the link-mode AUC / Hits@K cannot score: "
                "pair it with eval_mode='multiclass' or keep the scalar "
                "predictor.")
    else:
        raise ValueError(f"unknown eval_mode {cfg.eval_mode!r}")


class LLPModel(nn.Module):
    """The run's modules: the fixed ``features`` [N, M] (a buffer), the
    trained ``student`` (MLP, M -> hidden) and ``predictor``, and the
    frozen ``teacher`` (dense GAT, M -> M, ``teacher_heads`` heads) and
    ``teacher_predictor``; initialised in the JAX run's order from
    ``generator``."""

    def __init__(self, n: int, m: int, gdp: torch.Tensor, cfg, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d = cfg.hidden_channels
        self.register_buffer("features",
                             features_with_gdp(n, m, gdp, generator))
        self.student = MLP(cfg.num_layers, m, d, d, cfg.dropout,
                           generator=generator)
        self.predictor = LinkPredictor(cfg.predictor, d, cfg.num_layers,
                                       cfg.dropout, cfg.final_linear,
                                       generator=generator)
        self.teacher = GAT(m, m, cfg.teacher_heads, cfg.dropout,
                           generator=generator)
        self.teacher_predictor = LinkPredictor(
            cfg.predictor, m, cfg.num_layers, cfg.dropout, cfg.final_linear,
            generator=generator)
        self.teacher.requires_grad_(False)
        self.teacher_predictor.requires_grad_(False)

    def trained_parameters(self):
        """The student's and the predictor's: the optimiser's."""
        return [*self.student.parameters(), *self.predictor.parameters()]

    @torch.no_grad()
    def teacher_embedding(self, inter_mask: torch.Tensor) -> torch.Tensor:
        """The teacher's [N, M] output on the dense edge mask, out of
        training: a constant of the run."""
        return self.teacher(inter_mask, self.features, train=False)

    @torch.no_grad()
    def score_edges(self, src: torch.Tensor, dst: torch.Tensor
                    ) -> torch.Tensor:
        """The student's scores of the pairs ``(src, dst)``, out of
        training (only the queried rows are encoded: exact, the student is
        row-local)."""
        h = self.student(self.features[torch.cat([src, dst]).long()],
                         train=False)
        h_s, h_d = h.chunk(2)
        return self.predictor(h_s, h_d, train=False)


def _wmean(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted batch mean, a per-sample matrix reduced over its trailing
    axes first; padded entries carry weight 0."""
    if x.dim() > 1:
        x = x.mean(dim=tuple(range(1, x.dim())))
    return (x * w).sum() / w.sum().clamp_min(1.0)


def llp_loss_parts(model: LLPModel, t_h: torch.Tensor, pos_s, pos_r, neg_r,
                   w, lbl, cfg, generator: Optional[torch.Generator] = None):
    """One batch's loss and parts (``label``, ``kd_cosine``, ``kd_mse``,
    and ``kd_rank`` when ``cfg.kd_rank > 0``): ``w`` the padding weights,
    ``lbl`` 1 for observed records and 0 for sampled KD-only pairs.  The
    student encodes the ``3B`` rows of ``pos_s``, ``pos_r``, ``neg_r``.
    Returns ``(total, parts)``."""
    idx = torch.cat([pos_s, pos_r, neg_r]).long()
    h3 = model.student(model.features[idx], train=True, generator=generator)
    h_ps, h_pr, h_nr = h3.chunk(3)
    pos_score = model.predictor(h_ps, h_pr, train=True, generator=generator)
    neg_score = model.predictor(h_ps, h_nr, train=True, generator=generator)
    w_lbl = w * lbl
    # clipped as bce_loss clips: a saturated sigmoid gives -log(0) = inf,
    # and inf * 0 = NaN would poison even the masked rows
    eps_s = 1e-7
    pos_c = pos_score.clamp(eps_s, 1.0 - eps_s)
    neg_c = neg_score.clamp(eps_s, 1.0 - eps_s)
    label = 0.5 * (_wmean(-torch.log(pos_c), w_lbl)
                   + _wmean(-torch.log(1.0 - neg_c), w_lbl))
    with torch.no_grad():
        t_ps = t_h[pos_s.long()]
        t_pos = model.teacher_predictor(t_ps, t_h[pos_r.long()], train=False)
    eps = 1e-8
    cos_row = (h_ps * t_ps).sum(-1) / torch.sqrt(
        ((h_ps * h_ps).sum(-1) + eps) * ((t_ps * t_ps).sum(-1) + eps))
    cos = 1.0 - _wmean(cos_row, w)
    mse = _wmean((pos_score - t_pos) ** 2, w)
    total = cfg.true_label * label + cfg.kd_f * cos + cfg.kd_p * mse
    parts = {"label": label, "kd_cosine": cos, "kd_mse": mse}
    if cfg.kd_rank > 0.0:
        # the student keeps the teacher's order of each (pos, neg) pair by
        # at least the margin
        with torch.no_grad():
            t_neg = model.teacher_predictor(t_ps, t_h[neg_r.long()],
                                            train=False)
            sign = torch.sign(t_pos - t_neg)
        rank = _wmean(torch.relu(cfg.margin - sign * (pos_score - neg_score)),
                      w)
        total = total + cfg.kd_rank * rank
        parts["kd_rank"] = rank
    return total, parts


def llp_epoch_arrays(rng: np.random.Generator, cfg, src: np.ndarray,
                     dst: np.ndarray, train_ids: np.ndarray, fg: FlowGraph,
                     rev_graph=None):
    """One epoch's ``[S, B]`` arrays ``(pos_s, pos_r, neg_r, w, lbl)``,
    drawn as the JAX run draws them: the observed train records and, with
    ``ps_samples > 0``, the sampled KD-only pairs (padded to a fixed
    ``ps_samples * rw_step`` slots at weight 0; 'rw' walks forced to an odd
    hop count so they end on the recipient side), permuted and padded to
    whole batches at weight 0, then recipient negatives in ``[0, M)``."""
    n, m = fg.n_src, fg.n_dst
    pos_s_ep = src[train_ids]
    pos_r_ep = dst[train_ids]
    lbl_ep = np.ones(len(train_ids), np.float32)
    w_ep = np.ones(len(train_ids), np.float32)
    if cfg.ps_samples > 0:
        anchors = rng.integers(0, n, cfg.ps_samples)
        if cfg.ps_method == "nb":
            a, p = sample_positives_nearby(rng, fg.inter, anchors,
                                           rw_step=cfg.rw_step)
        elif cfg.ps_method == "rw":
            hops = cfg.hops if cfg.hops % 2 == 1 else cfg.hops + 1
            a, p, _ = sample_positives_rw(rng, fg.inter, rev_graph, anchors,
                                          hops=hops, rw_step=cfg.rw_step)
        else:
            raise ValueError(f"unknown ps_method {cfg.ps_method!r}")
        cap = cfg.ps_samples * cfg.rw_step
        a, p = a[:cap], p[:cap]
        pad_k = cap - len(a)
        pos_s_ep = np.concatenate([pos_s_ep, a, np.zeros(pad_k, np.int32)])
        pos_r_ep = np.concatenate([pos_r_ep, p, np.zeros(pad_k, np.int32)])
        lbl_ep = np.concatenate([lbl_ep, np.zeros(cap, np.float32)])
        w_ep = np.concatenate([w_ep, np.ones(len(a), np.float32),
                               np.zeros(pad_k, np.float32)])
    perm = rng.permutation(len(pos_s_ep))
    b = cfg.batch_size
    steps = -(-len(perm) // b)
    pad = steps * b - len(perm)
    sel = np.concatenate([perm, np.zeros(pad, perm.dtype)])
    w_s = np.concatenate([w_ep[perm], np.zeros(pad, np.float32)])
    neg_r = sample_negatives(rng, steps * b, m, cfg.ns_rate)[: steps * b]
    return (pos_s_ep[sel].reshape(steps, b), pos_r_ep[sel].reshape(steps, b),
            neg_r.reshape(steps, b), w_s.reshape(steps, b),
            lbl_ep[sel].reshape(steps, b))


def teacher_mask(fg: FlowGraph, cfg, train_ids, val_ids,
                 device) -> torch.Tensor:
    """The teacher's dense [N, M] edge mask: every record's edge without a
    val split (the reference's behaviour); with one, the train records'
    (+ the val records' under ``use_valedges_as_input``)."""
    if cfg.val_fraction <= 0.0:
        return fg.inter.to(device).to_dense() > 0
    vis = train_ids
    if cfg.use_valedges_as_input:
        vis = np.concatenate([train_ids, val_ids])
    mask = np.zeros((fg.n_src, fg.n_dst), dtype=bool)
    mask[fg.edge_src.numpy()[vis], fg.edge_dst.numpy()[vis]] = True
    return torch.from_numpy(mask).to(device)


@dataclasses.dataclass
class LLPRun:
    """Everything one LLP run holds: the flow data and its record split,
    the model on the device, its optimiser and dropout generator, the
    teacher's embedding, and the numpy generator of the epochs' draws."""

    cfg: object
    fg: FlowGraph
    src: np.ndarray
    dst: np.ndarray
    train_ids: np.ndarray
    val_ids: np.ndarray
    test_ids: np.ndarray
    model: LLPModel
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    t_h: torch.Tensor
    rng: np.random.Generator
    rev_graph: Optional[object]
    device: torch.device


def build_llp(cfg, fg: FlowGraph, device="cuda") -> LLPRun:
    """Set-up of a run: the guards, the 90/10 record split (and the val
    split), the model initialised from ``cfg.seed`` on the CPU and moved,
    Adam over the student and the predictor, and the teacher's
    embedding."""
    dev = resolve_device(device)
    n, m = fg.n_src, fg.n_dst
    check_llp_config(cfg, m)
    train_ids, test_ids = train_test_split_records(fg.num_records, 0.9,
                                                   cfg.seed)
    val_ids = np.zeros(0, np.int64)
    if cfg.val_fraction > 0.0:
        n_val = int(cfg.val_fraction * len(train_ids))
        val_ids, train_ids = train_ids[:n_val], train_ids[n_val:]
    model = LLPModel(n, m, fg.gdp, cfg,
                     generator=torch.Generator().manual_seed(cfg.seed))
    model = model.to(dev)
    t_h = model.teacher_embedding(teacher_mask(fg, cfg, train_ids, val_ids,
                                               dev))
    rev_graph = fg.inter.transpose() if (
        cfg.ps_samples > 0 and cfg.ps_method == "rw") else None
    return LLPRun(
        cfg=cfg, fg=fg, src=fg.edge_src.numpy(), dst=fg.edge_dst.numpy(),
        train_ids=train_ids, val_ids=val_ids, test_ids=test_ids,
        model=model,
        optimizer=adam_l2(model.trained_parameters(), cfg.lr, 0.0),
        generator=torch.Generator(device=dev).manual_seed(cfg.seed),
        t_h=t_h, rng=np.random.default_rng(cfg.seed), rev_graph=rev_graph,
        device=dev)


def epoch_tensors(run: LLPRun):
    """One epoch's batches (:func:`llp_epoch_arrays`, from the run's
    generator) on the device at once: ``idx`` [S, 3, B] (``pos_s``,
    ``pos_r``, ``neg_r``) and ``wl`` [S, 2, B] (``w``, ``lbl``)."""
    ps, pr, nr, w, lbl = llp_epoch_arrays(run.rng, run.cfg, run.src, run.dst,
                                          run.train_ids, run.fg,
                                          run.rev_graph)
    idx = torch.from_numpy(np.stack([ps, pr, nr], axis=1).astype(np.int64))
    wl = torch.from_numpy(np.stack([w, lbl], axis=1).astype(np.float32))
    return idx.to(run.device), wl.to(run.device)


def llp_step(run: LLPRun, idx: torch.Tensor, wl: torch.Tensor):
    """One optimiser step on a batch (``idx`` [3, B], ``wl`` [2, B]);
    returns the loss and its parts, on the device, not read."""
    run.optimizer.zero_grad(set_to_none=True)
    loss, parts = llp_loss_parts(run.model, run.t_h, *idx, *wl, run.cfg,
                                 run.generator)
    loss.backward()
    run.optimizer.step()
    return loss.detach(), {k: v.detach() for k, v in parts.items()}


def evaluate_llp(run: LLPRun, ids: np.ndarray,
                 neg_rng: np.random.Generator) -> dict:
    """The records ``ids`` scored by the student: AUC and Hits@K against
    one recipient negative each, drawn from ``neg_rng`` in ``[0, M)`` (the
    domain the positives come from), or the classification report in
    multiclass mode."""
    cfg, dev = run.cfg, run.device

    def on_dev(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(dev)

    def scores(ids):
        parts = [run.model.score_edges(on_dev(run.src[sel]),
                                       on_dev(run.dst[sel]))
                 for sel in (ids[i: i + cfg.batch_size]
                             for i in range(0, len(ids), cfg.batch_size))]
        return torch.cat(parts) if parts else torch.zeros(0, device=dev)

    if cfg.eval_mode == "multiclass":
        report = classification_report(scores(ids), on_dev(run.dst[ids]))
        values = torch.stack([v.float() for v in report.values()])
        return dict(zip(report, values.tolist()))
    pos = scores(ids)
    neg_src = run.src[ids] if len(ids) else np.zeros(1, np.int32)
    neg_dst = neg_rng.integers(0, run.fg.n_dst, max(len(ids), 1))
    neg = run.model.score_edges(on_dev(neg_src), on_dev(neg_dst))
    return {"auc": binary_auc(pos.cpu().numpy(), neg.cpu().numpy()),
            "hits@20": float(hits_at_k(pos, neg, 20)),
            "hits@50": float(hits_at_k(pos, neg, 50))}


def run_llp(cfg, log=None, fg: Optional[FlowGraph] = None,
            device="cuda") -> dict:
    """Train the KD link-prediction pipeline; returns the final metrics
    (``auc``, ``hits@20``, ``hits@50`` in link mode; the classification
    report in multiclass mode), ``final_train_loss`` and, with a val
    split, ``best_val_<metric>`` (and ``early_stopped_epoch``)."""
    log = log or (lambda r: None)
    if fg is None:
        fg = load_flow_graph(cfg.year, cfg.data_dir)
    run = build_llp(cfg, fg, device)
    history = []
    best_metric, best_state, evals_since_best = -np.inf, None, 0
    stopped_epoch = None
    for epoch in range(cfg.epochs):
        t0 = time.time()
        steps = [llp_step(run, idx, wl) for idx, wl in
                 zip(*epoch_tensors(run))]
        # the epoch's mean loss and its last step's parts, read at once
        parts = steps[-1][1]
        values = torch.stack([torch.stack([s[0] for s in steps]).mean(),
                              *parts.values()]).tolist()
        history.append(values[0])
        log({"event": "llp_train_epoch", "epoch": epoch, "loss": values[0],
             "seconds": time.time() - t0, **dict(zip(parts, values[1:]))})

        if len(run.val_ids) and (epoch + 1) % max(cfg.eval_steps, 1) == 0:
            val = evaluate_llp(run, run.val_ids,
                               np.random.default_rng(cfg.seed + 1))
            score = val[cfg.metric]
            log({"event": "llp_val", "epoch": epoch, **val})
            if score > best_metric:
                best_metric, evals_since_best = score, 0
                best_state = {k: v.detach().clone()
                              for k, v in run.model.state_dict().items()}
            else:
                evals_since_best += 1
                if evals_since_best >= cfg.patience:
                    stopped_epoch = epoch
                    break
    if best_state is not None:
        run.model.load_state_dict(best_state)

    result = {**evaluate_llp(run, run.test_ids, run.rng),
              "final_train_loss": history[-1] if history else float("nan")}
    if len(run.val_ids):
        result["best_val_" + cfg.metric] = (
            float(best_metric) if best_metric > -np.inf else float("nan"))
    if stopped_epoch is not None:
        result["early_stopped_epoch"] = stopped_epoch
    log({"event": "llp_eval", **result})
    return result
