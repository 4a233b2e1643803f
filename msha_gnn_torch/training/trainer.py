"""The :class:`Task` a model plugs in as (``msha_gnn_tpu/training/trainer.py``).

Only the task is ported so far; the flow models' optimizer and training
loop are still to port (the link-prediction loop is in
``link_prediction.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional


@dataclasses.dataclass(frozen=True)
class Task:
    """``forward(model, batch_idx, *, train) -> (log_scores, mutated)``.

    ``log_scores``: [B, M] per-batch log-probabilities; ``mutated`` is {}
    for the stateless models ported so far.  ``full_scores(model)`` gives
    the [N, M] matrix in one full-graph forward, for models whose eval
    scores do not depend on the batch.  ``graph`` is the graph the forward
    propagates over.
    """

    forward: Callable[..., Any]
    full_scores: Optional[Callable[..., Any]] = None
    graph: Any = None
