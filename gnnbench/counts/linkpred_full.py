"""Operations of one full-graph GAT link-prediction step
(``training/link_prediction.py``'s ``LinkPredModel``, MLP predictor).

Counted: each attention layer's GEMM ``x W`` (2 n d_in d) with its two
gradients, its sender and receiver terms (2 n d each) with their
gradients and ``da``, its aggregation over the message graph (2 E d) and
that backward (4 E d); the predictor's Hadamard product, its hidden
linear layers (2 B h^2 each) and output layer (2 B h), each backward
twice, for the positives and the negatives; Adam over every parameter.
Not counted: the per-edge logit, softmax and dropout scalars, elu, relu,
the dropout masks, the BCE.
"""

from __future__ import annotations

from . import ADAM_FLOPS


def _layer(n: int, e: int, d_in: int, d: int) -> int:
    return 3 * 2 * n * d_in * d + 3 * 2 * 2 * n * d + 6 * e * d


def work(shape: dict) -> dict:
    n, e, h, heads, layers, b = (int(shape[k]) for k in (
        "nodes", "edges", "hidden", "heads", "predictor_layers", "batch"))
    encoder = heads * _layer(n, e, h, h) + _layer(n, e, heads * h, h)
    hidden = layers - 1
    pair_set = 3 * b * h + 3 * 2 * b * h * h * hidden + 3 * 2 * b * h
    params = (n * h + heads * (h * h + 2 * h) + heads * h * h + 2 * h
              + hidden * (h * h + h) + h + 1)
    return {"flops": encoder + 2 * pair_set + ADAM_FLOPS * params,
            "attention_layers": [(n, n, e, h)] * (heads + 1)}
