"""MSHA, the multi-semantic hierarchical attention model
(``msha_gnn_tpu/models/msha.py``), the flow models' flagship.

One parametrised model covers the presets of ``TrainConfig.model_flags``:

==============  ==============================================
preset           configuration
==============  ==============================================
``msha``/``ours`` ``MSHA(use_intra=True, joint_softmax=True)``
``ablation1``    ``MSHA(n_heads=1, use_out_att=False)``
``ablation2``    ``MSHA(joint_softmax=False)`` (intra softmax on its own)
``ablation3``    ``MSHA(use_intra=False)`` (the inter channel only)
==============  ==============================================

The layout is the JAX package's: head-stacked parameters ``W1``, ``W2``
``[H, in, d]`` and ``a``, ``a3``, ``a4`` ``[H, 2d, 1]``; every big tensor
2-D in the ``[rows, H d]`` head-major concat; the per-head contractions
against the M side as single matmuls through block-diagonal forms.

* The inter channel keeps a dense ``[N, H, M]`` attention (M = 32), its
  logits the rank-1 split of the reference's concat, masked with -9e15
  before the row softmax: a source row with no recipient edge comes out
  uniform.
* The intra city / province channels never form ``(B, N)``: the
  self-concat logits are constant per row, so the masked softmax and
  ``att.T @ h`` reduce to per-sample scalars and group-keyed segment sums
  (:mod:`msha_gnn_torch.ops.grouped`), the two broadcasts fused through a
  :class:`~msha_gnn_torch.graph.PairGrouping`.
* The joint softmax shares one denominator across the city clique, the
  province clique and, a quirk kept, the exponentials of the already
  softmaxed, post-dropout inter attention row.  Dropout on the intra
  weights drops whole per-sample rows.

Everything here is plain PyTorch (cuBLAS GEMMs, ``index_add_``): the JAX
model reaches no Pallas kernel either.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..graph import Grouping, PairGrouping
from ..ops import MASK_VALUE, group_scatter, pair_scatter, take_rows
from .common import (BatchNorm, dropout, elu, gdp_feature_init, leaky_relu,
                     xavier_uniform_stacked)
from .gat import MaskedGATLayer


class MSHALayer(nn.Module):
    """All heads of one MSHA attention layer; the output is the heads'
    feature-axis concat ``[R, H M]`` (head-major)."""

    def __init__(self, in_features: int, out_features: int,
                 dropout: float = 0.5, *, use_intra: bool = True,
                 joint_softmax: bool = True, n_heads: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.dropout = dropout
        self.use_intra, self.joint_softmax = use_intra, joint_softmax
        self.n_heads = n_heads
        nh, d = n_heads, out_features

        def stacked(*shape):
            return nn.Parameter(xavier_uniform_stacked(shape, generator))

        self.W1 = stacked(nh, in_features, d)
        self.W2 = stacked(nh, in_features, d)
        self.a = stacked(nh, 2 * d, 1)
        if use_intra:
            self.a3 = stacked(nh, 2 * d, 1)
            self.a4 = stacked(nh, 2 * d, 1)
        self.bn1 = BatchNorm(nh * d)
        self.bn2 = BatchNorm(nh * d)

    def forward(self, s_input: torch.Tensor, r_input: torch.Tensor,
                inter_mask: torch.Tensor, city: Grouping,
                province: Grouping, batch: torch.Tensor, *, train: bool,
                rows: Optional[torch.Tensor] = None,
                pair: Optional[PairGrouping] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``s_input`` [N, in], ``r_input`` [M, in], ``inter_mask`` [N, M]
        bool, ``batch`` [B] the minibatch's source rows; the output's rows
        are ``rows`` (all N when None)."""
        d, nh, din = self.out_features, self.n_heads, self.in_features
        n, m = inter_mask.shape

        def drop(x):
            return dropout(x, self.dropout, train, generator)

        w1c = self.W1.permute(1, 0, 2).reshape(din, nh * d)
        w2c = self.W2.permute(1, 0, 2).reshape(din, nh * d)
        h1c = r_input @ w1c  # [M, Hd]
        h2c = s_input @ w2c  # [N, Hd]

        # the inter (bipartite) channel: [h1_j || h2_i] . a_h split as
        # h1_j . a_h[:d] + h2_i . a_h[d:] (the recipient's projection first)
        a = self.a[..., 0]
        s_dst = torch.einsum("mhd,hd->mh", h1c.reshape(m, nh, d), a[:, :d])
        s_src = torch.einsum("nhd,hd->nh", h2c.reshape(n, nh, d), a[:, d:])
        e12 = leaky_relu(s_src[:, :, None] + s_dst.T[None, :, :])  # [N,H,M]
        e12 = torch.where(inter_mask[:, None, :], e12, MASK_VALUE)
        att = drop(torch.softmax(e12, dim=-1))
        attc = att.reshape(n, nh * m)

        if self.use_intra:
            a3, a4 = self.a3[..., 0], self.a4[..., 0]
            h2_bh = take_rows(h2c, batch).reshape(-1, nh, d)
            # self-concat logits, constant per row: [h_b || h_b] . a3 ==
            # h_b . (a3_lo + a3_hi)
            c3 = leaky_relu(torch.einsum("bhd,hd->bh", h2_bh,
                                         a3[:, :d] + a3[:, d:]))
            c4 = leaky_relu(torch.einsum("bhd,hd->bh", h2_bh,
                                         a4[:, :d] + a4[:, d:]))
            b = batch.long()
            cnt_city = city.counts[city.group_id[b].long()].to(h2c.dtype)
            cnt_prov = province.counts[province.group_id[b].long()].to(
                h2c.dtype)
            if self.joint_softmax:
                # one denominator across the three channels: a clique's
                # masked entries add exp(-9e15) = 0, its |clique| unmasked
                # ones exp(c) each; the inter term sums exp() of the
                # softmaxed, post-dropout attention (the reference's quirk)
                att_b = take_rows(attc, batch).reshape(-1, nh, m)
                denom = (cnt_city[:, None] * torch.exp(c3)
                         + cnt_prov[:, None] * torch.exp(c4)
                         + torch.exp(att_b).sum(dim=-1))
                w3 = torch.exp(c3) / denom
                w4 = torch.exp(c4) / denom
            else:
                # ablation2: a constant-row masked softmax is uniform over
                # the clique
                w3 = (1.0 / cnt_city)[:, None].expand_as(c3)
                w4 = (1.0 / cnt_prov)[:, None].expand_as(c4)
            w3, w4 = drop(w3), drop(w4)
            contrib3 = (w3[:, :, None] * h2_bh).reshape(-1, nh * d)
            contrib4 = (w4[:, :, None] * h2_bh).reshape(-1, nh * d)
            if pair is not None:
                intra_nc = pair_scatter(contrib3, contrib4, city, province,
                                        pair, batch)
            else:
                intra_nc = (group_scatter(contrib3, city, batch)
                            + group_scatter(contrib4, province, batch))
        else:
            intra_nc = 0.0

        # aggregation and bilinear scoring; the per-head contractions
        # against the M side as 2-D matmuls through block-diagonal forms
        eye = torch.eye(nh, dtype=h1c.dtype, device=h1c.device)
        bd_h1 = torch.einsum("mhd,hk->hmkd", h1c.reshape(m, nh, d),
                             eye).reshape(nh * m, nh * d)
        inter_rc = attc @ bd_h1                  # [N, Hd]: att_inter @ h1
        vfull = attc.T @ h2c                     # [HM, Hd]
        heads = torch.arange(nh, device=h1c.device)
        v = vfull.reshape(nh, m, nh, d)[heads, :, heads, :]  # [H, M, d]
        v = v.transpose(0, 1).reshape(m, nh * d)  # att_inter.T @ h2
        v = leaky_relu(self.bn1(v, train))       # [M, Hd]
        u = leaky_relu(self.bn2(inter_rc + intra_nc, train))  # [N, Hd]
        # row-local from here: both norms took their statistics over all
        # N rows, so scoring only ``rows`` is exact
        if rows is not None:
            u = take_rows(u, rows)
        bd_v = torch.einsum("mhd,hk->hdkm", v.reshape(m, nh, d),
                            eye).reshape(nh * d, nh * m)
        return elu(u @ bd_v)  # [R, HM]: the heads' u_h @ v_h.T, concat


class MSHA(nn.Module):
    """The multi-head wrapper: learnable source features with the GDP
    scalar in the last column and learnable recipient features, the
    attention layer (heads concat to ``[N, M H]``), then the masked
    :class:`~msha_gnn_torch.models.gat.MaskedGATLayer` back to ``[N, M]``
    (``use_out_att``), elu, log-softmax."""

    def __init__(self, in_features: int, out_features: int, n_classes: int,
                 n_heads: int = 2, dropout: float = 0.5, *,
                 use_intra: bool = True, joint_softmax: bool = True,
                 use_out_att: bool = True, gdp: torch.Tensor,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_classes, self.n_heads = n_classes, n_heads
        self.dropout = dropout
        self.use_out_att = use_out_att
        self.Sfeatures = nn.Parameter(
            gdp_feature_init(gdp, in_features, generator))
        self.Rfeatures = nn.Parameter(
            torch.rand((n_classes, in_features), generator=generator))
        self.attention = MSHALayer(
            in_features, out_features, dropout, use_intra=use_intra,
            joint_softmax=joint_softmax, n_heads=n_heads,
            generator=generator)
        if use_out_att:
            self.out_att = MaskedGATLayer(n_classes * n_heads, n_classes,
                                          dropout, generator=generator)

    def forward(self, inter_mask: torch.Tensor, city: Grouping,
                province: Grouping, batch: torch.Tensor, *, train: bool,
                rows: Optional[torch.Tensor] = None,
                pair: Optional[PairGrouping] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Log-probabilities ``[R, M]`` of ``rows`` (all N when None)."""
        def drop(x):
            return dropout(x, self.dropout, train, generator)

        x = self.attention(drop(self.Sfeatures), drop(self.Rfeatures),
                           inter_mask, city, province, batch, train=train,
                           rows=rows, pair=pair, generator=generator)
        x = drop(x)
        out_mask = inter_mask if rows is None else inter_mask[rows.long()]
        if self.use_out_att:
            x = elu(self.out_att(x, out_mask, train=train,
                                 generator=generator))
        else:
            x = elu(x)  # ablation1
        return F.log_softmax(x, dim=1)
