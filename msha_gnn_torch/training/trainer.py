"""Generic minibatch trainer for the flow-classification models
(``msha_gnn_tpu/training/trainer.py``).

Edge-record minibatches, the NLL of the batch rows, Adam with coupled L2
and the full metric block after every epoch.  The batches are the JAX
package's: an epoch's order is ``np.random.default_rng(seed +
epoch).permutation`` of the records, and the last batch is padded with
index 0 at weight 0.  The padding is part of full MSHA's result (its intra
channels attend within the batch), so it is kept, not cut.

The JAX trainer scans ``steps_per_dispatch`` steps in one jitted dispatch;
here a step is eager PyTorch, and ``steps_per_dispatch`` keeps its meaning
for the host: the loss of a chunk of that many steps stays on the device
and is read once per chunk.  The dropout masks come from one
``torch.Generator`` on the model's device.

A model plugs in as a :class:`Task`: a ``forward`` from (model, batch
indices) to per-batch log-scores, closed over the static graph inputs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..utils import prof
from .losses import nll_loss
from .metrics import classification_report


@dataclasses.dataclass(frozen=True)
class Task:
    """``forward(model, batch_idx, *, train, generator=None) ->
    (log_scores, mutated)``.

    ``log_scores``: [B, M] per-batch log-probabilities; ``mutated`` is {}:
    a model with batch statistics (MSHA) updates its running statistics in
    place, where the JAX task returns them.  ``optimizer(params)`` makes
    the task's optimiser (the JAX task's ``tx``); ``loss_fn(log_scores,
    labels, weights)`` is the training loss.  ``full_scores(model)`` gives
    the [N, M] matrix in one full-graph forward, for models whose eval
    scores do not depend on the batch.  ``graph`` is the graph the forward
    propagates over.
    """

    forward: Callable[..., Any]
    optimizer: Optional[Callable[..., torch.optim.Optimizer]] = None
    loss_fn: Callable[..., torch.Tensor] = nll_loss
    full_scores: Optional[Callable[..., Any]] = None
    graph: Any = None


@dataclasses.dataclass
class TrainState:
    """The model, its optimiser and the count of steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @staticmethod
    def create(model: nn.Module, optimizer: Callable[..., Any]
               ) -> "TrainState":
        """A fresh state: ``optimizer`` (a task's factory) over the
        model's parameters."""
        if optimizer is None:
            raise ValueError("the task has no optimizer")
        return TrainState(model=model,
                          optimizer=optimizer(model.parameters()))

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def _train_step_body(task: Task, state: TrainState, batch_idx, labels,
                     weights, generator):
    state.optimizer.zero_grad(set_to_none=True)
    scores, _ = task.forward(state.model, batch_idx, train=True,
                             generator=generator)
    loss = task.loss_fn(scores, labels, weights)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return loss.detach()


def make_train_step(task: Task):
    """``step(state, batch_idx, labels, weights, generator)``: one
    optimiser step, the state updated in place; returns the loss on the
    device, not read."""

    def step(state: TrainState, batch_idx, labels, weights,
             generator: Optional[torch.Generator] = None):
        return _train_step_body(task, state, batch_idx, labels, weights,
                                generator)

    return step


def make_train_multi_step(task: Task):
    """``multi_step(state, batch_idx_s, labels_s, weights_s, generator)``:
    the steps of ``[S, B]`` stacked batches in order; returns their mean
    loss on the device, not read."""

    def multi_step(state: TrainState, batch_idx_s, labels_s, weights_s,
                   generator: Optional[torch.Generator] = None):
        losses = [_train_step_body(task, state, b, lab, w, generator)
                  for b, lab, w in zip(batch_idx_s, labels_s, weights_s)]
        return torch.stack(losses).mean()

    return multi_step


def make_eval_step(task: Task):
    """``step(state, batch_idx, labels) -> (scores [B, M], per-row NLL
    [B])`` in eval mode."""

    def step(state: TrainState, batch_idx, labels):
        with torch.inference_mode():
            scores, _ = task.forward(state.model, batch_idx, train=False)
            per = -scores.gather(1, labels.long()[:, None])[:, 0]
        return scores, per

    return step


def make_eval_multi_step(task: Task):
    """The eval step over ``[S, B]`` stacked batches -> ``[S, B, M]``
    scores and ``[S, B]`` per-row NLL."""
    step = make_eval_step(task)

    def multi(state: TrainState, batch_idx_s, labels_s):
        outs = [step(state, b, lab) for b, lab in zip(batch_idx_s, labels_s)]
        return (torch.stack([s for s, _ in outs]),
                torch.stack([p for _, p in outs]))

    return multi


def _batches(n: int, batch_size: int, *, shuffle: bool,
             rng: np.random.Generator):
    """One batch at a time: (int32 [B] indices into the records, float32
    [B] weights), the last batch padded with index 0 at weight 0."""
    order = rng.permutation(n) if shuffle else np.arange(n)
    for i in range(0, n, batch_size):
        chunk = order[i: i + batch_size]
        w = np.ones(batch_size, np.float32)
        if len(chunk) < batch_size:
            w[len(chunk):] = 0.0
            chunk = np.concatenate(
                [chunk, np.zeros(batch_size - len(chunk), chunk.dtype)])
        yield chunk.astype(np.int32), w


def _stacked_batches(n: int, batch_size: int, *, shuffle: bool,
                     rng: np.random.Generator):
    """All of an epoch's batches stacked: ([S, B] indices into the
    records, [S, B] weights)."""
    order = rng.permutation(n) if shuffle else np.arange(n)
    steps = -(-n // batch_size)
    pad = steps * batch_size - n
    idx = np.concatenate([order, np.zeros(pad, order.dtype)])
    w = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    return idx.reshape(steps, batch_size), w.reshape(steps, batch_size)


def _on(dev, a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@dataclasses.dataclass
class Trainer:
    """The epoch loop, with JSONL logging.

    ``src`` and ``labels`` are numpy [num_records]: each record's source
    index and recipient label.  An epoch's batches go to the device at
    once; the losses of ``steps_per_dispatch`` steps are summed there and
    read once.
    """

    task: Task
    src: np.ndarray
    labels: np.ndarray
    batch_size: int = 64
    seed: int = 42
    steps_per_dispatch: int = 64
    log: Optional[Callable[[Dict], None]] = None

    def __post_init__(self):
        self._multi_step = make_train_multi_step(self.task)
        self._eval_multi = make_eval_multi_step(self.task)

    def _chunks(self, steps: int):
        d = max(1, self.steps_per_dispatch)
        for lo in range(0, steps, d):
            yield lo, min(lo + d, steps)

    def train_epoch(self, state: TrainState, record_ids: np.ndarray,
                    generator: Optional[torch.Generator], epoch: int):
        """One epoch over ``record_ids`` -> ``(state, mean loss)``."""
        t0 = time.time()
        dev = state.device
        idx_s, w_s = _stacked_batches(
            len(record_ids), self.batch_size, shuffle=True,
            rng=np.random.default_rng(self.seed + epoch))
        ids_s = record_ids[idx_s]
        src_s = _on(dev, self.src[ids_s].astype(np.int64))
        lab_s = _on(dev, self.labels[ids_s].astype(np.int64))
        w_s = _on(dev, w_s)
        total, count = 0.0, 0
        for lo, hi in self._chunks(idx_s.shape[0]):
            loss = self._multi_step(state, src_s[lo:hi], lab_s[lo:hi],
                                    w_s[lo:hi], generator)
            total += float(loss) * (hi - lo)
            count += hi - lo
        avg = total / max(count, 1)
        if self.log:
            self.log({"event": "train_epoch", "epoch": epoch, "loss": avg,
                      "seconds": time.time() - t0})
        return state, avg

    def _report(self, scores: torch.Tensor, labels: torch.Tensor,
                loss: torch.Tensor) -> Dict:
        """The metric block and ``loss`` as floats, in one read."""
        report = {**classification_report(scores, labels), "loss": loss}
        values = torch.stack([v.float() for v in report.values()]).tolist()
        report = dict(zip(report, values))
        if self.log:
            self.log({"event": "eval", **report})
        return report

    def evaluate(self, state: TrainState, record_ids: np.ndarray) -> Dict:
        """The metric block and the mean NLL over ``record_ids``: from one
        full-graph forward when the task has ``full_scores``, else from
        per-batch forwards of padded batches, the padding left out."""
        dev = state.device
        if self.task.full_scores is not None:
            full = self.task.full_scores(state.model)  # [N, M]
            scores = full[_on(dev, self.src[record_ids].astype(np.int64))]
            labels = _on(dev, self.labels[record_ids].astype(np.int64))
            return self._report(scores, labels, nll_loss(scores, labels))
        idx_s, w_s = _stacked_batches(
            len(record_ids), self.batch_size, shuffle=False,
            rng=np.random.default_rng(0))
        ids_s = record_ids[idx_s]
        src_s = _on(dev, self.src[ids_s].astype(np.int64))
        lab_s = _on(dev, self.labels[ids_s].astype(np.int64))
        scores_all, per_all = [], []
        for lo, hi in self._chunks(idx_s.shape[0]):
            scores, per = self._eval_multi(state, src_s[lo:hi], lab_s[lo:hi])
            scores_all.append(scores.reshape(-1, scores.shape[-1]))
            per_all.append(per.reshape(-1))
        keep = np.flatnonzero(w_s.reshape(-1) > 0)
        kept = _on(dev, keep)
        scores = torch.cat(scores_all).index_select(0, kept)
        labels = lab_s.reshape(-1).index_select(0, kept)
        loss = torch.cat(per_all).index_select(0, kept).sum() \
            / max(len(keep), 1)
        return self._report(scores, labels, loss)

    def fit(self, state: TrainState, train_ids, test_ids, epochs: int,
            generator: Optional[torch.Generator] = None, profile_dir=None):
        """Epoch loop -> ``(state, history)``, one ``{"epoch",
        "train_loss", **report}`` an epoch.  ``generator`` (default: seeded
        from ``seed`` on the model's device) draws the dropout masks;
        ``profile_dir`` captures a ``torch.profiler`` trace of the epochs
        (the spans ``train_epoch_<i>`` / ``eval_<i>``)."""
        if generator is None:
            generator = torch.Generator(device=state.device).manual_seed(
                self.seed)
        history = []
        with prof.trace(profile_dir):
            for epoch in range(epochs):
                with prof.span(f"train_epoch_{epoch}"):
                    state, loss = self.train_epoch(state, train_ids,
                                                   generator, epoch)
                with prof.span(f"eval_{epoch}"):
                    report = self.evaluate(state, test_ids)
                history.append({"epoch": epoch, "train_loss": loss,
                                **report})
        return state, history
