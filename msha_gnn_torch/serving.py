"""Batch inference on a flow-classification model (``msha_gnn_tpu/serving.py``).

Two paths, as in the JAX package:

* a model whose eval scores do not depend on the batch (GCN, MSHA's
  ablation3) exposes ``Task.full_scores``: ONE full-graph forward gives
  the [N, M] log-probability matrix, which stays cached on the device,
  and every query is a gather from it;
* a batch-dependent model (full MSHA: its intra channels attend within
  the batch) runs the per-batch forward on chunks padded with node 0 to
  exactly ``batch_size`` rows.  Its scores depend on the batch's
  composition, padding included, by construction; the same padding as
  the JAX package's gives the same scores.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass
class Predictor:
    """Scorer over a :class:`~.training.trainer.Task` and its model."""

    task: "object"            # training.trainer.Task
    model: nn.Module
    batch_size: int = 1024    # the per-batch path's padded batch
    _full: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                      repr=False)

    @classmethod
    def from_state(cls, task, model: nn.Module,
                   batch_size: int = 1024) -> "Predictor":
        return cls(task=task, model=model, batch_size=batch_size)

    def _full_scores(self) -> torch.Tensor:
        if self._full is None:
            self._full = self.task.full_scores(self.model)
        return self._full

    def log_scores(self, nodes: Sequence[int]) -> np.ndarray:
        """[len(nodes), M] log-probabilities over recipient classes."""
        nodes = np.asarray(nodes, np.int64)
        if self.task.full_scores is not None:
            full = self._full_scores()
            idx = torch.as_tensor(nodes, device=full.device)
            return full.index_select(0, idx).cpu().numpy()
        self.model.eval()
        bs, out = self.batch_size, []
        with torch.inference_mode():
            for lo in range(0, len(nodes), bs):
                chunk = nodes[lo:lo + bs]
                padded = np.concatenate(
                    [chunk, np.zeros(bs - len(chunk), np.int64)])
                scores, _ = self.task.forward(
                    self.model, torch.from_numpy(padded), train=False)
                out.append(scores[: len(chunk)].cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0, 0), np.float32)

    def top_k(self, nodes: Sequence[int], k: int = 5,
              class_names: Optional[Dict[int, str]] = None) -> List[dict]:
        """Per node: the k most likely recipient classes with probabilities."""
        log_p = self.log_scores(nodes)
        p = np.exp(log_p)
        k = min(k, p.shape[1]) if p.size else 0
        order = np.argsort(-p, axis=1)[:, :k]
        results = []
        for i, node in enumerate(np.asarray(nodes)):
            entry = {"node": int(node), "top": []}
            for j in order[i]:
                rec = {"class": int(j), "p": float(p[i, j])}
                if class_names is not None:
                    rec["name"] = class_names.get(int(j), str(int(j)))
                entry["top"].append(rec)
            results.append(entry)
        return results


def recipient_names(data_dir: str, year: str) -> Dict[int, str]:
    """Invert ``Adjacent{year}.json``'s ``recipient_index`` name->idx map."""
    from .data.flow import load_index_match

    _, _, recipient_index = load_index_match(
        os.path.join(data_dir, f"Adjacent{year}.json")
    )
    return {int(v): k for k, v in recipient_index.items()}


def restore_predictor(cfg, batch_size: int = 1024, device="cuda"):
    """Load ``cfg``'s data, build its task on ``device`` and restore
    ``cfg.checkpoint_dir`` into the model.  Returns
    ``(predictor, flow_graph, checkpoint_step)``."""
    from .cli import _build_task
    from .data import load_flow_graph
    from .training.checkpoint import restore_checkpoint

    fg = load_flow_graph(cfg.year, cfg.data_dir)
    built = _build_task(cfg, fg, device)
    if built is None:
        raise ValueError(f"model {cfg.model!r} is not ported")
    task, model = built
    model, _, step = restore_checkpoint(cfg.checkpoint_dir, model)
    return Predictor.from_state(task, model, batch_size=batch_size), fg, step


def run_predict(cfg, nodes: str, top_k: int, output: Optional[str],
                batch_size: int = 1024, device="cuda") -> dict:
    """CLI glue: restore ``cfg.checkpoint_dir``, score ``nodes``.

    ``nodes``: ``'all'``, a comma list of indices, or ``@path`` to a file
    with one index per line.  Writes JSONL (one line per node) to
    ``output`` or stdout; returns a summary dict.
    """
    predictor, fg, step = restore_predictor(cfg, batch_size, device)

    if nodes == "all":
        node_ids = np.arange(fg.n_src, dtype=np.int32)
    elif nodes.startswith("@"):
        with open(nodes[1:]) as f:
            node_ids = np.asarray([int(l) for l in f if l.strip()], np.int32)
    else:
        node_ids = np.asarray([int(s) for s in nodes.split(",") if s],
                              np.int32)
    if node_ids.size and (node_ids.min() < 0 or node_ids.max() >= fg.n_src):
        raise ValueError(
            f"node index out of range [0, {fg.n_src}): "
            f"{node_ids.min()}..{node_ids.max()}"
        )

    names = recipient_names(cfg.data_dir, cfg.year)
    results = predictor.top_k(node_ids, k=top_k, class_names=names)

    sink = open(output, "w") if output else sys.stdout
    try:
        for r in results:
            sink.write(json.dumps(r, ensure_ascii=False) + "\n")
    finally:
        if output:
            sink.close()
    return {"nodes": int(node_ids.size), "checkpoint_step": int(step),
            "output": output or "-"}
