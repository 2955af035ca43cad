"""Public op: masked segment-sum (K2) with the ``impl=`` switch of
:mod:`repro_torch.kernels.impl`: the CUDA kernel on a CUDA tensor, the
plain version on a CPU tensor. Also :func:`gather_edges`, the keyed row
gather whose backward is K2, and :func:`keyed_rows`, which takes it on the
card where a gradient is wanted."""
from __future__ import annotations

from typing import Optional

import torch

from ..dst_groups import EdgeGroups, dst_groups, edge_groups
from ..impl import resolve_impl
from .kernel import segment_sum_cuda
from .ref import segment_sum_ref


def segment_sum(msg: torch.Tensor, edge_dst: torch.Tensor,
                edge_mask: torch.Tensor, num_dst: int, impl: str = "auto",
                groups: Optional[EdgeGroups] = None) -> torch.Tensor:
    """``groups`` lets a layer share one destination-grouped order between
    K1 and K2; it is built here when not given."""
    if resolve_impl(impl, msg) == "ref":
        return segment_sum_ref(msg, edge_dst, edge_mask, num_dst)
    if groups is None:
        groups = dst_groups(edge_dst, edge_mask, num_dst)
    return segment_sum_cuda(msg, groups)


class _GatherEdges(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, keys, edge_mask, groups):
        ctx.groups = groups
        return x[keys.long()].masked_fill(~edge_mask[:, None], 0)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        grad_x = segment_sum_cuda(grad.contiguous(), ctx.groups)
        return grad_x, None, None, None


def gather_edges(x: torch.Tensor, keys: torch.Tensor,
                 edge_mask: torch.Tensor, groups: EdgeGroups) -> torch.Tensor:
    """x: (N, F) on the card; keys: (E,) -> (E, F), ``x[keys]`` on live
    edges and 0 on padded ones. Its gradient, ``grad_x[k] = sum of the live
    edges' rows keyed k``, is K2 over ``groups`` (the edges grouped by the
    same keys), in each group's edge order: the deterministic stand-in for
    the float-atomic ``index_put_`` behind ``x[keys]``'s own backward."""
    return _GatherEdges.apply(x, keys, edge_mask, groups)


def keyed_rows(x: torch.Tensor, idx: torch.Tensor,
               impl: str = "auto") -> torch.Tensor:
    """``x[idx]`` for an index tensor of any shape -> idx.shape + (F,).
    Where indices repeat (a token id within a batch, a row gathered once
    for each of its experts, in-batch negatives), a gradient on the card
    is summed by K2 over the indices grouped in their order
    (:func:`gather_edges`), not by the float atomics of ``index_select``'s
    backward; on the CPU, and without a gradient, ``index_select``."""
    flat = idx.reshape(-1).to(torch.int32)
    if (resolve_impl(impl, x) == "cuda" and torch.is_grad_enabled()
            and x.requires_grad):
        live = torch.ones_like(flat, dtype=torch.bool)
        rows = gather_edges(x, flat, live,
                            edge_groups(flat, live, x.shape[0]))
    else:
        rows = x.index_select(0, flat.long())
    return rows.view(*idx.shape, x.shape[-1])
