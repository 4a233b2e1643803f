from .cuda.spmm import segment_reduce_sorted
from .segment import segment_max, segment_softmax, segment_sum
from .sparse import edge_softmax, sddmm, sddmm_dot, spmm

__all__ = ["segment_max", "segment_softmax", "segment_sum", "edge_softmax",
           "sddmm", "sddmm_dot", "segment_reduce_sorted", "spmm"]
