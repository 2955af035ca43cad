"""Plain PyTorch version of K1, fused gather -> aggregate. Like
``repro/kernels/fused_gather_aggregate/ref.py`` it is the segment-sum
oracle applied to the gathered rows: the CPU path of the port and the
oracle the CUDA kernel is held against."""
from __future__ import annotations

import torch

from ..segment_sum.ref import segment_sum_ref


def fused_gather_aggregate_ref(h_src: torch.Tensor, edge_src: torch.Tensor,
                               edge_dst: torch.Tensor,
                               edge_mask: torch.Tensor,
                               num_dst: int) -> torch.Tensor:
    """h_src: (V, F); edge_src/edge_dst: (E,); -> (num_dst, F) masked sum
    of gathered source rows per destination."""
    return segment_sum_ref(h_src[edge_src.long()], edge_dst, edge_mask,
                           num_dst)
