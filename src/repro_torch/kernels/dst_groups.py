"""Destination-grouped edge order, the index bookkeeping K1 and K2 share.

The sampler emits a block's edges grouped by owner partition, not by
destination, and ``pad_block`` pads ``edge_dst`` with 0 and relies on the
mask alone. The CUDA kernels reduce per destination, so each block gets,
once, a STABLE sort of its edges by key (``dst`` where the mask is set,
``num_dst`` where it is not) and the CSR offsets of the live keys: every
destination then sums its live edges in their original order, and padded
edges sort past ``offsets[num_dst]``. The order is built with
``torch.sort(stable=True)`` and ``torch.searchsorted``; it is no part of
what the TPU kernels computed.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DstGroups:
    order: torch.Tensor     # (E,) int32: edge ids, live edges grouped by dst
    offsets: torch.Tensor   # (num_dst + 1,) int32: live edges of d are
                            # order[offsets[d]:offsets[d + 1]]
    num_dst: int


def dst_groups(edge_dst: torch.Tensor, edge_mask: torch.Tensor,
               num_dst: int) -> DstGroups:
    """edge_dst: (E,) int; edge_mask: (E,) bool -> :class:`DstGroups`."""
    if edge_dst.dim() != 1 or edge_mask.shape != edge_dst.shape:
        raise ValueError(f"edge_dst {tuple(edge_dst.shape)} and edge_mask "
                         f"{tuple(edge_mask.shape)} must be the same (E,)")
    if edge_dst.numel() >= 2 ** 31 or num_dst >= 2 ** 31:
        raise ValueError("the kernels index edges and rows with int32")
    keys = edge_dst.to(torch.int32).masked_fill(~edge_mask, num_dst)
    sorted_keys, order = torch.sort(keys, stable=True)
    bounds = torch.arange(num_dst + 1, dtype=torch.int32,
                          device=edge_dst.device)
    offsets = torch.searchsorted(sorted_keys, bounds, out_int32=True)
    return DstGroups(order.to(torch.int32), offsets, int(num_dst))
