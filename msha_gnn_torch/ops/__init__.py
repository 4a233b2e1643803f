from .segment import segment_sum
from .sparse import spmm

__all__ = ["segment_sum", "spmm"]
