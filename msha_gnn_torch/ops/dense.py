"""Dense masked-attention ops (``msha_gnn_tpu/ops/dense.py``).

They reproduce the reference's dense formulation: the same masked -9e15
row softmax and the same rank-1 logits, without the ``(N, M, 2d')`` concat
tensors (``[x || y] . a == x . a_lo + y . a_hi`` with ``a = [a_lo;
a_hi]``).  MSHA's N x 32 inter channel runs on them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

MASK_VALUE = -9e15  # the reference's masking constant


def masked_row_softmax(e: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``softmax(where(mask, e, -9e15), dim=-1)``.  A row with no unmasked
    entry comes out uniform (all its logits equal), as in the reference;
    ``-inf`` or a segment softmax would give it zeros."""
    return torch.softmax(torch.where(mask, e, MASK_VALUE), dim=-1)


def bipartite_rank1_logits(h_src: torch.Tensor, h_dst: torch.Tensor,
                           a: torch.Tensor, *, negative_slope: float = 0.2
                           ) -> torch.Tensor:
    """``e[i, j] = leaky_relu([h_dst[j] || h_src[i]] . a)`` -> [N, M], with
    ``a`` [2 d', 1] split as ``a_dst = a[:d']``, ``a_src = a[d':]`` (the
    reference puts the recipient's projection first)."""
    d = h_src.shape[-1]
    a = a.reshape(2 * d)
    return F.leaky_relu((h_src @ a[d:])[:, None] + (h_dst @ a[:d])[None, :],
                        negative_slope)


def self_concat_logits(h: torch.Tensor, a: torch.Tensor, *,
                       negative_slope: float = 0.2) -> torch.Tensor:
    """The reference GAT's logits ``[h_i || h_i] . a``: the per-row scalar
    ``leaky_relu(h_i . (a_lo + a_hi))`` -> [N].  After a masked row
    softmax they give uniform attention over each row's unmasked entries,
    the reference's behaviour."""
    d = h.shape[-1]
    a = a.reshape(2 * d)
    return F.leaky_relu(h @ (a[:d] + a[d:]), negative_slope)


def pairwise_rank1_logits(h_row: torch.Tensor, h_col: torch.Tensor,
                          a: torch.Tensor, *, negative_slope: float = 0.2
                          ) -> torch.Tensor:
    """HGANE's pairwise logits ``e[i, j] = leaky_relu([h_row[i] ||
    h_col[j]] . a)`` -> [B, B]."""
    d = h_row.shape[-1]
    a = a.reshape(2 * d)
    return F.leaky_relu((h_row @ a[:d])[:, None] + (h_col @ a[d:])[None, :],
                        negative_slope)


def dropout(x: torch.Tensor, rate: float, *,
            generator: Optional[torch.Generator],
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout with its keep mask drawn from ``generator`` (on
    ``x``'s device); the identity when ``deterministic`` or at rate 0, as
    flax's ``nn.Dropout``."""
    if deterministic or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)
