from .kernel import fused_gather_aggregate_cuda
from .ops import fused_gather_aggregate
from .ref import fused_gather_aggregate_ref

__all__ = ["fused_gather_aggregate", "fused_gather_aggregate_cuda",
           "fused_gather_aggregate_ref"]
