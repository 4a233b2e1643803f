from .segment import segment_max, segment_softmax, segment_sum
from .sparse import edge_softmax, sddmm, spmm

__all__ = ["segment_max", "segment_softmax", "segment_sum", "edge_softmax",
           "sddmm", "spmm"]
