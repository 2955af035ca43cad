"""Public op: per-destination edge softmax (K4) with the ``impl=`` switch
of :mod:`repro_torch.kernels.impl`: the CUDA kernels (statistics, then
normalize) on a CUDA tensor, the plain version on a CPU tensor.

K4 has no backward of its own: on the training path it runs inside K3
(its statistics in the forward, its normalize in the backward). Given
scores that require a gradient where autograd records, the CUDA path
raises rather than return an output that would silently cut the graph;
under ``torch.no_grad()`` no graph is built, and it runs."""
from __future__ import annotations

from typing import Optional

import torch

from ..dst_groups import EdgeGroups, dst_groups
from ..impl import resolve_impl
from .kernel import edge_softmax_norm_cuda, edge_softmax_stats_cuda
from .ref import edge_softmax_ref


def edge_softmax(scores: torch.Tensor, edge_dst: torch.Tensor,
                 edge_mask: torch.Tensor, num_dst: int, impl: str = "auto",
                 groups: Optional[EdgeGroups] = None) -> torch.Tensor:
    """scores: (E, H) -> alpha (E, H); ``groups`` (the destination
    groups) is built here when not given."""
    if resolve_impl(impl, scores) == "ref":
        return edge_softmax_ref(scores, edge_dst, edge_mask, num_dst)
    if scores.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "edge_softmax on the card has no backward of its own; "
            "differentiate through fused_edge_softmax_aggregate (K3), or "
            "port a standalone K4 backward (ROADMAP queue B)")
    edge_dst = edge_dst.to(torch.int32).contiguous()
    if groups is None:
        groups = dst_groups(edge_dst, edge_mask, num_dst)
    m, z = edge_softmax_stats_cuda(scores, groups)
    return edge_softmax_norm_cuda(scores, edge_dst, edge_mask, m, z)
