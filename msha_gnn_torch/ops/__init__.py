from .cuda.spmm import segment_reduce_sorted
from .dense import (MASK_VALUE, bipartite_rank1_logits, masked_row_softmax,
                    pairwise_rank1_logits, self_concat_logits)
from .grouped import (clique_exp_row_sum, clique_masked_softmax_dense,
                      clique_row_scalar_logits, clique_weighted_scatter,
                      gather_by_group, group_scatter, pair_scatter, take_rows)
from .segment import (segment_max, segment_mean, segment_normalize,
                      segment_softmax, segment_sum)
from .sparse import PRECISIONS, edge_softmax, sddmm, sddmm_dot, spmm

__all__ = ["MASK_VALUE", "PRECISIONS", "bipartite_rank1_logits",
           "clique_exp_row_sum", "clique_masked_softmax_dense",
           "clique_row_scalar_logits", "clique_weighted_scatter",
           "edge_softmax", "gather_by_group", "group_scatter",
           "masked_row_softmax", "pair_scatter", "pairwise_rank1_logits",
           "sddmm", "sddmm_dot", "segment_max", "segment_mean",
           "segment_normalize", "segment_reduce_sorted", "segment_softmax",
           "segment_sum", "self_concat_logits", "spmm", "take_rows"]
