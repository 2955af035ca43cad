"""Plain PyTorch version of K2, masked segment-sum. It mirrors
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
