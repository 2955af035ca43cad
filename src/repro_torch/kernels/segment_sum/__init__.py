from .kernel import segment_sum_cuda
from .ops import gather_edges, segment_sum
from .ref import segment_sum_ref

__all__ = ["gather_edges", "segment_sum", "segment_sum_cuda", "segment_sum_ref"]
