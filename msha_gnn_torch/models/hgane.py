"""HGANE, the batch-sliced hierarchical attention baseline
(``msha_gnn_tpu/models/hgane.py``).

The layer cuts everything to the minibatch before its attention: the
inter block ``[B, M]`` (the batch's rows of the inter mask) and the intra
block ``[B, B]`` (same group id within the batch), both materialised.  Its
intra logits are proper pairwise ``[h_i || h_j] . a3``.  The softmax is
the reference's, kept as it computes it: sums of raw exponentials with no
maximum subtracted; the intra channel's denominator sums over both the
intra and the inter masked logits, the inter channel's over its own.  The
aggregation projects the raw embeddings through ``W1`` / ``W2``.  Plain
PyTorch, as the JAX model is XLA code.

A logit above about 88 overflows ``exp`` to inf in float32, in both
packages alike; the initialisation keeps the logits far below it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..graph import Grouping
from ..ops import MASK_VALUE
from .common import BatchNorm, dropout, elu, leaky_relu, xavier_uniform


class HGANELayer(nn.Module):
    """``HGANELayer``: ``source_embedding`` [n_src, in] and
    ``recipient_embedding`` [n_dst, in] in U[0, 1); ``W1``, ``W2`` [in, d],
    ``a12``, ``a3`` [2 d, 1], xavier at gain 1; ``bn1``, ``bn2`` flax batch
    norms over d features.  The output is the ``[B, M]`` score matrix
    ``elu(u @ v.T)``."""

    def __init__(self, in_features: int, out_features: int, n_src: int,
                 n_dst: int, dropout: float = 0.5, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_features, self.dropout = out_features, dropout
        d_in, d = in_features, out_features
        self.source_embedding = nn.Parameter(
            torch.rand((n_src, d_in), generator=generator))
        self.recipient_embedding = nn.Parameter(
            torch.rand((n_dst, d_in), generator=generator))
        self.W1 = nn.Parameter(xavier_uniform((d_in, d), generator, 1.0))
        self.W2 = nn.Parameter(xavier_uniform((d_in, d), generator, 1.0))
        self.a12 = nn.Parameter(xavier_uniform((2 * d, 1), generator, 1.0))
        self.a3 = nn.Parameter(xavier_uniform((2 * d, 1), generator, 1.0))
        self.bn1 = BatchNorm(d)
        self.bn2 = BatchNorm(d)

    def forward(self, inter_mask_rows: torch.Tensor, intra: Grouping,
                batch: torch.Tensor, *, train: bool,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``inter_mask_rows`` [B, M] bool (the inter mask's rows of the
        batch), ``intra`` the grouping of the intra channel, ``batch``
        [B] the source rows; in training the norms take the batch's
        statistics and update their running ones in place."""
        d = self.out_features
        batch = batch.long()
        s_b = self.source_embedding[batch]               # [B, in]
        r_emb = self.recipient_embedding
        h1 = r_emb @ self.W1                             # [M, d]
        h2 = s_b @ self.W2                               # [B, d]
        av = self.a12.reshape(2 * d)
        e12 = leaky_relu((h1 @ av[:d])[None, :] + (h2 @ av[d:])[:, None])
        a3v = self.a3.reshape(2 * d)
        e3 = leaky_relu((h2 @ a3v[:d])[:, None] + (h2 @ a3v[d:])[None, :])

        gid_b = intra.group_id[batch]
        intra_mask = gid_b[:, None] == gid_b[None, :]    # [B, B]
        att_inter = torch.where(inter_mask_rows, e12, MASK_VALUE)
        att_intra = torch.where(intra_mask, e3, MASK_VALUE)

        # raw-exp sums, no maximum subtracted (the reference's arithmetic)
        exp_inter = torch.exp(att_inter)
        exp_intra = torch.exp(att_intra)
        sum_inter = exp_inter.sum(dim=1, keepdim=True)
        att_intra = exp_intra / (exp_intra.sum(dim=1, keepdim=True)
                                 + sum_inter)
        att_intra = dropout(att_intra, self.dropout, train, generator)
        att_inter = exp_inter / sum_inter
        att_inter = dropout(att_inter, self.dropout, train, generator)

        u = leaky_relu(self.bn1((att_inter @ r_emb) @ self.W1
                                + (att_intra @ s_b) @ self.W2, train))
        v = leaky_relu(self.bn2((att_inter.T @ s_b) @ self.W1, train))
        return elu(u @ v.T)                              # [B, M]
