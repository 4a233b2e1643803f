"""Operations of one out-of-core step of the rank-1 GAT link predictor
(``training/scale.py``'s model) over the whole graph.

Counted: the GEMMs ``h = feat W`` (2 N d^2) with its two gradients, the
sender and receiver terms ``h a`` (2 N d each) with their gradients and
``da``, the aggregation (2 E d) and its backward (``<dagg, h[r]>`` and
``att dagg`` into ``dh[r]``: 4 E d), the batch's dot products forward and
backward (positives and negatives, 2 B d each way and set), and Adam.
Not counted: a logit's add, leaky relu, exponent and division a edge,
elu and the residual, the BCE (a few operations an edge or row).
"""

from __future__ import annotations

from . import ADAM_FLOPS


def work(shape: dict) -> dict:
    n, e, d, b = (int(shape[k]) for k in ("nodes", "edges", "d", "batch"))
    gemm = 3 * 2 * n * d * d
    terms = 3 * 2 * 2 * n * d
    attention = 2 * e * d + 4 * e * d
    scores = 3 * 2 * 2 * b * d
    adam = ADAM_FLOPS * (n * d + d * d + 2 * d)
    return {"flops": gemm + terms + attention + scores + adam,
            "attention_layers": [(n, n, e, d)]}
