from .dense import (dense_max, dense_merge_counters, dense_merge_elems,
                    dense_merge_lww, segment_sum)
from .segment import NEUTRAL_T, merge_counters, merge_elems, next_pow2, scatter_max4

__all__ = [
    "NEUTRAL_T", "merge_counters", "merge_elems", "next_pow2", "scatter_max4",
    "dense_max", "dense_merge_counters", "dense_merge_elems", "dense_merge_lww",
    "segment_sum",
]
