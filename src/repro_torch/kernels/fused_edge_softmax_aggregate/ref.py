"""Plain PyTorch version of K3, the fused attention tail (edge softmax ->
weighted gather -> segment-sum). It mirrors
``repro/kernels/fused_edge_softmax_aggregate/ref.py`` expression for
expression: the CPU path of the port and the oracle the CUDA kernels are
held against."""
from __future__ import annotations

import torch

from ..edge_softmax.ref import edge_softmax_ref
from ..segment_sum.ref import segment_sum_ref


def fused_edge_softmax_aggregate_ref(h_proj: torch.Tensor,
                                     scores: torch.Tensor,
                                     edge_src: torch.Tensor,
                                     edge_dst: torch.Tensor,
                                     edge_mask: torch.Tensor,
                                     num_dst: int) -> torch.Tensor:
    """h_proj: (V, H, Dh); scores: (E, H) -> (num_dst, H*Dh): per-dst
    softmax over incoming edges, attention-weighted sum of source rows."""
    alpha = edge_softmax_ref(scores, edge_dst, edge_mask, num_dst)
    msg = (h_proj.index_select(0, edge_src.long()) * alpha[:, :, None]).reshape(
        edge_src.shape[0], -1)
    return segment_sum_ref(msg, edge_dst, edge_mask, num_dst)
