"""Segment primitives (``msha_gnn_tpu/ops/segment.py``) over torch tensors.

Out-of-range ids (padding edges use ``num_segments``) are dropped, as
``jax.ops.segment_*`` drops them: they land in one extra bucket past the
last, which is cut off (no boolean mask, so no host sync on the card).
These are plain PyTorch: the CPU path and the oracles of the kernels.
"""

from __future__ import annotations

from typing import Optional

import torch


def _bucketed(segment_ids: torch.Tensor, num_segments: int):
    """The ids as int64, every out-of-range one moved to the extra bucket
    ``num_segments``."""
    ids = segment_ids.long()
    return torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum ``data`` rows into ``num_segments`` buckets."""
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    out.index_add_(0, _bucketed(segment_ids, num_segments), data)
    return out[:num_segments]


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Max of ``data`` rows per bucket; an empty bucket is ``-inf``, as
    ``jax.ops.segment_max`` gives."""
    out = data.new_full((num_segments + 1,) + tuple(data.shape[1:]),
                        float("-inf"))
    idx = _bucketed(segment_ids, num_segments).reshape(
        (-1,) + (1,) * (data.dim() - 1))
    return out.scatter_reduce(0, idx.expand_as(data), data, "amax",
                              include_self=True)[:num_segments]


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, *, mask: Optional[torch.Tensor] = None,
                    stable: bool = True) -> torch.Tensor:
    """Softmax within segments of a 1-D logit vector, its segment's max
    subtracted first when ``stable``.

    Entries outside ``mask`` get 0; an empty segment gives no entries.  An
    out-of-range id takes no part in any segment's max or sum, but its
    entry is normalised by the segment its id clips to (a padding id
    ``num_segments`` by the last), as in the JAX function, so a padding
    entry gets 0 only through ``mask``.
    """
    if mask is not None:
        logits = torch.where(mask, logits, float("-inf"))
    clip = segment_ids.long().clamp(0, num_segments - 1)
    if stable:
        seg_max = segment_max(logits, segment_ids, num_segments)
        seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
        logits = logits - seg_max[clip]
    ex = torch.exp(logits)
    if mask is not None:
        ex = torch.where(mask, ex, 0.0)
    return segment_normalize(ex, segment_ids, num_segments)


def segment_normalize(values: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Each entry over its segment's sum (no exp); a segment that sums to 0
    keeps its entries.  An out-of-range id is divided by the sum of the
    segment it clips to."""
    denom = segment_sum(values, segment_ids, num_segments)
    denom = torch.where(denom > 0, denom, 1.0)
    return values / denom[segment_ids.long().clamp(0, num_segments - 1)]


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Mean of ``data`` rows per bucket; an empty bucket gives 0."""
    total = segment_sum(data, segment_ids, num_segments)
    cnt = segment_sum(data.new_ones(segment_ids.shape[:1]), segment_ids,
                      num_segments)
    return total / cnt.clamp(min=1.0).reshape(
        (-1,) + (1,) * (total.dim() - 1))
