from .kernel import segment_sum_cuda
from .ops import gather_edges, keyed_rows, segment_sum
from .ref import segment_max_ref, segment_sum_ref

__all__ = ["gather_edges", "keyed_rows", "segment_sum", "segment_sum_cuda",
           "segment_max_ref", "segment_sum_ref"]
