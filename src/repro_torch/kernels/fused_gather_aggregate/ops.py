"""Public op: fused gather -> aggregate (K1) with the ``impl=`` switch of
:mod:`repro_torch.kernels.impl`: the CUDA kernel on a CUDA tensor, the
plain version on a CPU tensor.

On the card the op is a ``torch.autograd.Function``: its forward is K1's
kernel and its backward the source-keyed kernel
(:func:`~..src_scatter.src_scatter_cuda`,
``grad_h[v] = sum over v's live edges of grad_out[dst_e]``), launched only
when ``h_src`` needs a gradient (layer 0's input is features, so its
backward launches nothing). On the CPU the backward is PyTorch's autograd
through the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..dst_groups import EdgeGroups, dst_groups, src_groups
from ..impl import resolve_impl
from ..src_scatter import src_scatter_cuda
from .kernel import fused_gather_aggregate_cuda
from .ref import fused_gather_aggregate_ref


class FusedGatherAggregate(torch.autograd.Function):
    """K1 with its backward kernel; ``groups`` are the destination
    groups of the forward. The source groups the backward reduces over
    are built in the backward, and only when it runs."""

    @staticmethod
    def forward(ctx, h_src, edge_src, edge_dst, edge_mask, groups):
        ctx.save_for_backward(edge_src, edge_dst, edge_mask)
        ctx.num_src = h_src.shape[0]
        return fused_gather_aggregate_cuda(h_src, edge_src, groups)

    @staticmethod
    def backward(ctx, grad_out):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        edge_src, edge_dst, edge_mask = ctx.saved_tensors
        by_src = src_groups(edge_src, edge_mask, ctx.num_src)
        grad_h = src_scatter_cuda(grad_out.contiguous(), edge_dst, by_src)
        return grad_h, None, None, None, None


def fused_gather_aggregate(h_src: torch.Tensor, edge_src: torch.Tensor,
                           edge_dst: torch.Tensor, edge_mask: torch.Tensor,
                           num_dst: int, impl: str = "auto",
                           groups: Optional[EdgeGroups] = None
                           ) -> torch.Tensor:
    """``groups`` lets a layer share one destination-grouped order between
    K1 and K2; it is built here when not given."""
    if resolve_impl(impl, h_src) == "ref":
        return fused_gather_aggregate_ref(h_src, edge_src, edge_dst,
                                          edge_mask, num_dst)
    if groups is None:
        groups = dst_groups(edge_dst, edge_mask, num_dst)
    return FusedGatherAggregate.apply(
        h_src, edge_src.to(torch.int32).contiguous(),
        edge_dst.to(torch.int32).contiguous(), edge_mask, groups)
