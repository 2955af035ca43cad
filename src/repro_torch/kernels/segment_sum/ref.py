"""Plain PyTorch version of K2, masked segment-sum, and of the reference's
masked segment-max. It mirrors
``repro/kernels/segment_sum/ref.py`` expression for expression: the CPU
path of the port and the oracle the CUDA kernel is held against.

out[d] = sum over edges e with edge_dst[e]==d and edge_mask[e] of msg[e].
"""
from __future__ import annotations

import torch


def segment_sum_ref(msg: torch.Tensor, edge_dst: torch.Tensor,
                    edge_mask: torch.Tensor, num_dst: int) -> torch.Tensor:
    """msg: (E, F); edge_dst: (E,) int; edge_mask: (E,) bool -> (num_dst, F)."""
    msg = torch.where(edge_mask[:, None], msg, 0)
    out = torch.zeros((num_dst,) + tuple(msg.shape[1:]), dtype=msg.dtype,
                      device=msg.device)
    return out.index_add_(0, edge_dst.long(), msg)


def segment_max_ref(x: torch.Tensor, edge_dst: torch.Tensor,
                    edge_mask: torch.Tensor, num_dst: int,
                    neutral: float = -1e30) -> torch.Tensor:
    """x: (E,) -> (num_dst,) per-destination max (masked). Masked edges
    give ``neutral``; a destination with no edge gives the dtype's lowest
    value (-inf, or the integer minimum) and an out-of-range destination
    is dropped, as ``jax.ops.segment_max`` does."""
    x = torch.where(edge_mask, x, neutral)
    dst = edge_dst.long()
    keep = (dst >= 0) & (dst < num_dst)
    x, dst = x[keep], dst[keep]
    lowest = (float("-inf") if x.dtype.is_floating_point
              else torch.iinfo(x.dtype).min)
    out = torch.full((num_dst,) + tuple(x.shape[1:]), lowest,
                     dtype=x.dtype, device=x.device)
    index = dst.view((-1,) + (1,) * (x.dim() - 1)).expand_as(x)
    return out.scatter_reduce_(0, index, x, "amax")
