"""Public op: the fused attention tail (K3) with the ``impl=`` switch of
:mod:`repro_torch.kernels.impl`: the CUDA kernels on a CUDA tensor, the
plain version on a CPU tensor.

On the card the op is a ``torch.autograd.Function``. Forward: K4's
statistics kernel, then K3's aggregate kernel; it saves the statistics and
its output. Backward, given ``G = dL/d out``: K4's normalize kernel gives
alpha from the saved statistics; K3's backward kernel gives
``dL/ds = alpha * (<G[dst], h_proj[src]> - <G[dst], out[dst]>)``
(FlashAttention's identity); the source-keyed kernel gives
``dL/dh_proj[v] = sum over v's live edges of alpha * G[dst]``. Each
backward kernel launches only when its input needs a gradient. On the CPU
the backward is PyTorch's autograd through the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..dst_groups import EdgeGroups, dst_groups, src_groups
from ..edge_softmax.kernel import (edge_softmax_norm_cuda,
                                   edge_softmax_stats_cuda)
from ..impl import resolve_impl
from ..src_scatter import src_scatter_cuda
from .kernel import (fused_edge_softmax_aggregate_bwd_cuda,
                     fused_edge_softmax_aggregate_cuda)
from .ref import fused_edge_softmax_aggregate_ref


class FusedEdgeSoftmaxAggregate(torch.autograd.Function):
    """K3 with its backward kernels. ``groups`` are the destination
    groups; ``by_src``, the source groups the backward into ``h_proj``
    reduces over, may be shared with the layer (it is built in the
    backward when not given)."""

    @staticmethod
    def forward(ctx, h_proj, scores, edge_src, edge_dst, edge_mask, groups,
                by_src):
        m, z = edge_softmax_stats_cuda(scores, groups)
        out = fused_edge_softmax_aggregate_cuda(h_proj, scores, edge_src,
                                                groups, m, z)
        ctx.save_for_backward(h_proj, scores, edge_src, edge_dst, edge_mask,
                              m, z, out)
        ctx.groups, ctx.by_src = groups, by_src
        return out

    @staticmethod
    def backward(ctx, grad_out):
        need_h, need_s = ctx.needs_input_grad[:2]
        if not (need_h or need_s):
            return (None,) * 7
        h_proj, scores, edge_src, edge_dst, edge_mask, m, z, out = \
            ctx.saved_tensors
        grad_out = grad_out.contiguous()
        alpha = edge_softmax_norm_cuda(scores, edge_dst, edge_mask, m, z)
        d_scores = d_h = None
        if need_s:
            d_scores = fused_edge_softmax_aggregate_bwd_cuda(
                grad_out, h_proj, out, alpha, edge_src, ctx.groups)
        if need_h:
            by_src = ctx.by_src
            if by_src is None:
                by_src = src_groups(edge_src, edge_mask, h_proj.shape[0])
            d_h = src_scatter_cuda(grad_out, edge_dst, by_src,
                                   weights=alpha).view(h_proj.shape)
        return d_h, d_scores, None, None, None, None, None


def fused_edge_softmax_aggregate(h_proj: torch.Tensor, scores: torch.Tensor,
                                 edge_src: torch.Tensor,
                                 edge_dst: torch.Tensor,
                                 edge_mask: torch.Tensor, num_dst: int,
                                 impl: str = "auto",
                                 groups: Optional[EdgeGroups] = None,
                                 by_src: Optional[EdgeGroups] = None
                                 ) -> torch.Tensor:
    """h_proj: (V, H, Dh); scores: (E, H) -> (num_dst, H*Dh). ``groups``
    (by destination) is built here when not given; ``by_src`` (by source)
    lets a layer share its source order with the backward."""
    if resolve_impl(impl, h_proj) == "ref":
        return fused_edge_softmax_aggregate_ref(h_proj, scores, edge_src,
                                                edge_dst, edge_mask, num_dst)
    edge_src = edge_src.to(torch.int32).contiguous()
    edge_dst = edge_dst.to(torch.int32).contiguous()
    if groups is None:
        groups = dst_groups(edge_dst, edge_mask, num_dst)
    return FusedEdgeSoftmaxAggregate.apply(
        h_proj.contiguous(), scores.contiguous(), edge_src, edge_dst,
        edge_mask.contiguous(), groups, by_src)
