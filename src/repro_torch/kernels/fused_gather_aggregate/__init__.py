from .kernel import fused_gather_aggregate_cuda
from .ops import FusedGatherAggregate, fused_gather_aggregate
from .ref import fused_gather_aggregate_ref

__all__ = ["FusedGatherAggregate", "fused_gather_aggregate",
           "fused_gather_aggregate_cuda", "fused_gather_aggregate_ref"]
