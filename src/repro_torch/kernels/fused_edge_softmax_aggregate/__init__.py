from .kernel import (fused_edge_softmax_aggregate_bwd_cuda,
                     fused_edge_softmax_aggregate_cuda)
from .ops import FusedEdgeSoftmaxAggregate, fused_edge_softmax_aggregate
from .ref import fused_edge_softmax_aggregate_ref

__all__ = ["FusedEdgeSoftmaxAggregate", "fused_edge_softmax_aggregate",
           "fused_edge_softmax_aggregate_bwd_cuda",
           "fused_edge_softmax_aggregate_cuda",
           "fused_edge_softmax_aggregate_ref"]
