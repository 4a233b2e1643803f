"""Segment primitives (``msha_gnn_tpu/ops/segment.py``) over torch tensors.

Out-of-range ids (padding edges use ``num_segments``) are dropped, as
``jax.ops.segment_*`` drops them.  These are plain PyTorch: the CPU path
and the oracles of the kernels.
"""

from __future__ import annotations

from typing import Optional

import torch


def _keep(segment_ids: torch.Tensor, num_segments: int):
    ids = segment_ids.long()
    return ids, (ids >= 0) & (ids < num_segments)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum ``data`` rows into ``num_segments`` buckets."""
    ids, keep = _keep(segment_ids, num_segments)
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, ids[keep], data[keep])


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Max of ``data`` rows per bucket; an empty bucket is ``-inf``, as
    ``jax.ops.segment_max`` gives."""
    ids, keep = _keep(segment_ids, num_segments)
    out = data.new_full((num_segments,) + tuple(data.shape[1:]),
                        float("-inf"))
    idx = ids[keep].reshape((-1,) + (1,) * (data.dim() - 1))
    return out.scatter_reduce(0, idx.expand_as(data[keep]), data[keep],
                              "amax", include_self=True)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, *, mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Numerically stable softmax within segments of a 1-D logit vector.

    Entries outside ``mask`` get 0; an empty segment gives no entries.  An
    out-of-range id takes no part in any segment's max or sum, but its
    entry is normalised by the segment its id clips to (a padding id
    ``num_segments`` by the last), as in the JAX function, so a padding
    entry gets 0 only through ``mask``.
    """
    if mask is not None:
        logits = torch.where(mask, logits, float("-inf"))
    clip = segment_ids.long().clamp(0, num_segments - 1)
    seg_max = segment_max(logits, segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    logits = logits - seg_max[clip]
    ex = torch.exp(logits)
    if mask is not None:
        ex = torch.where(mask, ex, 0.0)
    denom = segment_sum(ex, segment_ids, num_segments)
    denom = torch.where(denom > 0, denom, 1.0)
    return ex / denom[clip]
