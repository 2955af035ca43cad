"""Public op: fused gather -> aggregate (K1) with the ``impl=`` switch of
:mod:`repro_torch.kernels.impl`: the CUDA kernel on a CUDA tensor, the
plain version on a CPU tensor."""
from __future__ import annotations

from typing import Optional

import torch

from ..dst_groups import DstGroups, dst_groups
from ..impl import resolve_impl
from .kernel import fused_gather_aggregate_cuda
from .ref import fused_gather_aggregate_ref


def fused_gather_aggregate(h_src: torch.Tensor, edge_src: torch.Tensor,
                           edge_dst: torch.Tensor, edge_mask: torch.Tensor,
                           num_dst: int, impl: str = "auto",
                           groups: Optional[DstGroups] = None
                           ) -> torch.Tensor:
    """``groups`` lets a layer share one destination-grouped order between
    K1 and K2; it is built here when not given."""
    if resolve_impl(impl, h_src) == "ref":
        return fused_gather_aggregate_ref(h_src, edge_src, edge_dst,
                                          edge_mask, num_dst)
    if groups is None:
        groups = dst_groups(edge_dst, edge_mask, num_dst)
    return fused_gather_aggregate_cuda(h_src,
                                       edge_src.to(torch.int32).contiguous(),
                                       groups)
