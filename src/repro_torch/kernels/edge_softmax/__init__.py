from .kernel import edge_softmax_norm_cuda, edge_softmax_stats_cuda
from .ops import edge_softmax
from .ref import edge_softmax_ref

__all__ = ["edge_softmax", "edge_softmax_norm_cuda",
           "edge_softmax_stats_cuda", "edge_softmax_ref"]
