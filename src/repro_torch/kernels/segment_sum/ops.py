"""Public op: masked segment-sum (K2) with the ``impl=`` switch of
:mod:`repro_torch.kernels.impl`: the CUDA kernel on a CUDA tensor, the
plain version on a CPU tensor."""
from __future__ import annotations

from typing import Optional

import torch

from ..dst_groups import DstGroups, dst_groups
from ..impl import resolve_impl
from .kernel import segment_sum_cuda
from .ref import segment_sum_ref


def segment_sum(msg: torch.Tensor, edge_dst: torch.Tensor,
                edge_mask: torch.Tensor, num_dst: int, impl: str = "auto",
                groups: Optional[DstGroups] = None) -> torch.Tensor:
    """``groups`` lets a layer share one destination-grouped order between
    K1 and K2; it is built here when not given."""
    if resolve_impl(impl, msg) == "ref":
        return segment_sum_ref(msg, edge_dst, edge_mask, num_dst)
    if groups is None:
        groups = dst_groups(edge_dst, edge_mask, num_dst)
    return segment_sum_cuda(msg, groups)
