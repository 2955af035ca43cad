"""Plain PyTorch version of K4, the per-destination edge softmax (GAT
attention). It mirrors ``repro/kernels/edge_softmax/ref.py`` expression for
expression: the CPU path of the port and the oracle the CUDA kernels are
held against."""
from __future__ import annotations

import torch

_NEG = -1e30


def edge_softmax_ref(scores: torch.Tensor, edge_dst: torch.Tensor,
                     edge_mask: torch.Tensor, num_dst: int) -> torch.Tensor:
    """scores: (E, H); per-dst softmax over incoming edges, masked.

    Padded edges get weight 0. Destinations with no edges produce no
    contributions anywhere, so their (undefined) softmax never surfaces.
    """
    dst = edge_dst.long()
    s = torch.where(edge_mask[:, None], scores, _NEG)
    m = torch.full((num_dst, s.shape[1]), _NEG, dtype=s.dtype,
                   device=s.device)
    m = m.scatter_reduce(0, dst[:, None].expand_as(s), s, "amax",
                         include_self=True)                     # (N, H)
    m = torch.where(m <= _NEG / 2, 0.0, m)                      # empty dsts
    ex = torch.where(edge_mask[:, None], torch.exp(s - m.index_select(0, dst)), 0.0)
    denom = torch.zeros_like(m).index_add_(0, dst, ex)          # (N, H)
    denom = torch.clamp_min(denom, 1e-30)
    return ex / denom.index_select(0, dst)
