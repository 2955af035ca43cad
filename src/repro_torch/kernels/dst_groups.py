"""Key-grouped edge order, the index bookkeeping every CUDA kernel of the
port reduces over.

The sampler emits a block's edges grouped by owner partition, not by
destination or source, and ``pad_block`` pads ``edge_src`` and
``edge_dst`` with 0 and relies on the mask alone. The CUDA kernels reduce
per key without atomics, so each block gets a STABLE sort of its edges by
key (the key where the mask is set, ``num_keys`` where it is not) and the
CSR offsets of the live keys: every key then sums its live edges in their
original order, and padded edges sort past ``offsets[num_keys]``. The
sorted keys are kept too: a kernel that splits the order into chunks of
edges (the source-keyed ``src_scatter``) reads each position's key
directly.

Forward reductions (K1, K2, K3 and K4's statistics) are keyed by ``dst``
(:func:`dst_groups`); backward reductions into source rows (K1's and K3's
backward) are keyed by ``src`` (:func:`src_groups`). The order is built
with ``torch.sort(stable=True)`` and ``torch.searchsorted``; it is no part
of what the TPU kernels computed.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class EdgeGroups:
    order: torch.Tensor     # (E,) int32: edge ids, live edges grouped by key
    offsets: torch.Tensor   # (num_groups + 1,) int32: live edges of key k
                            # are order[offsets[k]:offsets[k + 1]]
    num_groups: int
    keys: torch.Tensor      # (E,) int32: the sorted keys, keys[i] the key
                            # of order[i] (num_groups past offsets[-1])


def edge_groups(keys: torch.Tensor, edge_mask: torch.Tensor,
                num_groups: int) -> EdgeGroups:
    """keys: (E,) int in [0, num_groups) where live; edge_mask: (E,) bool
    -> :class:`EdgeGroups`."""
    if keys.dim() != 1 or edge_mask.shape != keys.shape:
        raise ValueError(f"keys {tuple(keys.shape)} and edge_mask "
                         f"{tuple(edge_mask.shape)} must be the same (E,)")
    if keys.numel() >= 2 ** 31 or num_groups >= 2 ** 31:
        raise ValueError("the kernels index edges and rows with int32")
    masked = keys.to(torch.int32).masked_fill(~edge_mask, num_groups)
    sorted_keys, order = torch.sort(masked, stable=True)
    bounds = torch.arange(num_groups + 1, dtype=torch.int32,
                          device=keys.device)
    offsets = torch.searchsorted(sorted_keys, bounds, out_int32=True)
    return EdgeGroups(order.to(torch.int32), offsets, int(num_groups),
                      sorted_keys)


def dst_groups(edge_dst: torch.Tensor, edge_mask: torch.Tensor,
               num_dst: int) -> EdgeGroups:
    """Live edges grouped by destination: the forward reductions' order."""
    return edge_groups(edge_dst, edge_mask, num_dst)


def src_groups(edge_src: torch.Tensor, edge_mask: torch.Tensor,
               num_src: int) -> EdgeGroups:
    """Live edges grouped by source row: the backward reductions' order."""
    return edge_groups(edge_src, edge_mask, num_src)
