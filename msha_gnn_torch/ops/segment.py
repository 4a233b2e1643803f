"""Segment primitives (``msha_gnn_tpu/ops/segment.py``) over torch tensors."""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum ``data`` rows into ``num_segments`` buckets.

    Out-of-range ids (padding edges use ``num_segments``) are dropped, as
    ``jax.ops.segment_sum`` drops them.
    """
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, ids[keep], data[keep])
