"""Grouped-clique attention ops (``msha_gnn_tpu/ops/grouped.py``): MSHA's
intra-city and intra-province attention without the reference's dense
``(B, N)`` matrices.

The reference's intra logits are self-concat, so each row of its ``(B,
N)`` logit matrix is one constant, and its adjacency is a union of cliques
(same city, same province).  Every masked softmax and every ``att.T @ h``
then reduces to group-keyed segment ops on per-sample scalars, O(B + N)
work.  Exact in eval mode; under dropout the factored form drops whole
per-sample rows, not single ``(b, n)`` entries.

The JAX functions :func:`gather_by_group` and :func:`take_rows` carry a
custom VJP that turns the TPU's serial scatter-add into a one-hot matmul.
Here they are plain indexing, whose gradient is an accumulating scatter
(``index_add_``).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch
import torch.nn.functional as F

from .segment import segment_sum

if TYPE_CHECKING:
    from ..graph import Grouping, PairGrouping


def gather_by_group(per_group: torch.Tensor,
                    group_id: torch.Tensor) -> torch.Tensor:
    """``per_group[group_id]``."""
    return per_group[group_id.long()]


def take_rows(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``x[rows]``, the minibatch's rows."""
    return x[rows.long()]


def clique_row_scalar_logits(h_batch: torch.Tensor, a: torch.Tensor, *,
                             negative_slope: float = 0.2) -> torch.Tensor:
    """The per-sample intra logit ``c[b] = leaky_relu(h_batch[b] . (a_lo +
    a_hi))``: row b of the reference's ``(B, N)`` logit matrix."""
    d = h_batch.shape[-1]
    a = a.reshape(2 * d)
    return F.leaky_relu(h_batch @ (a[:d] + a[d:]), negative_slope)


def clique_exp_row_sum(row_logit: torch.Tensor, grouping: "Grouping",
                       batch_index: torch.Tensor) -> torch.Tensor:
    """``sum_n exp(masked_logits[b, n])`` of a clique-masked constant-row
    matrix: ``|group(b)| * exp(c[b])`` (the masked entries' exp(-9e15) is
    0)."""
    cnt = grouping.member_sizes()[batch_index.long()].to(row_logit.dtype)
    return cnt * torch.exp(row_logit)


def group_scatter(contrib: torch.Tensor, grouping: "Grouping",
                  batch_index: torch.Tensor) -> torch.Tensor:
    """``out[n] = sum_{b : group(b) == group(n)} contrib[b]`` -> [N, d]."""
    gid = grouping.group_id.long()
    per_group = segment_sum(contrib, gid[batch_index.long()],
                            grouping.num_groups)
    return gather_by_group(per_group, gid)


def pair_scatter(contrib_a: torch.Tensor, contrib_b: torch.Tensor,
                 grouping_a: "Grouping", grouping_b: "Grouping",
                 pair: "PairGrouping",
                 batch_index: torch.Tensor) -> torch.Tensor:
    """``group_scatter(contrib_a, grouping_a) + group_scatter(contrib_b,
    grouping_b)`` through the pair table: the two per-group tables are
    summed in pair space (K rows), so one N-row gather remains."""
    b = batch_index.long()
    pg_a = segment_sum(contrib_a, grouping_a.group_id.long()[b],
                       grouping_a.num_groups)
    pg_b = segment_sum(contrib_b, grouping_b.group_id.long()[b],
                       grouping_b.num_groups)
    table = pg_a[pair.a_of_pair.long()] + pg_b[pair.b_of_pair.long()]
    return gather_by_group(table, pair.pair_id)


def clique_weighted_scatter(weights: torch.Tensor, values: torch.Tensor,
                            grouping: "Grouping",
                            batch_index: torch.Tensor) -> torch.Tensor:
    """``att.T @ values`` for clique attention ``att[b, n] = weights[b] *
    1[n in group(b)]``: ``out[n] = sum_{b : group(b) == group(n)}
    weights[b] * values[b]``, in O(B d + G d)."""
    return group_scatter(weights[:, None] * values, grouping, batch_index)


def clique_masked_softmax_dense(row_logit: torch.Tensor,
                                grouping: "Grouping",
                                batch_index: torch.Tensor,
                                denom: torch.Tensor) -> torch.Tensor:
    """The ``(B, N)`` attention ``exp(row_logit[b]) / denom[b] * 1[n in
    group(b)]``, materialised (tests and explanation only)."""
    gid = grouping.group_id.long()
    mask = gid[batch_index.long()][:, None] == gid[None, :]
    return torch.where(mask, (torch.exp(row_logit) / denom)[:, None], 0.0)
