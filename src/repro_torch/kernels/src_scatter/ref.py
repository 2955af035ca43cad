"""Plain PyTorch version of the source-keyed weighted gather-sum, the
backward of K1 and of K3's projected-feature input (there is no reference
``ref.py`` for it: the reference differentiates its plain versions with
``jax.value_and_grad``). It is the segment-sum oracle keyed by source,
applied to the gradient rows each live edge reads: the oracle the CUDA
kernel is held against."""
from __future__ import annotations

from typing import Optional

import torch

from ..segment_sum.ref import segment_sum_ref


def src_scatter_ref(grad: torch.Tensor, edge_src: torch.Tensor,
                    edge_dst: torch.Tensor, edge_mask: torch.Tensor,
                    num_src: int,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """grad: (num_dst, F); edge_src/edge_dst: (E,); weights: (E, H) with
    F = H * Dh, or None -> (num_src, F):
    ``out[v] = sum over live e with src v of w[e] * grad[dst_e]``, where
    column c of head c // Dh takes ``weights[e, c // Dh]``."""
    msg = grad[edge_dst.long()]
    if weights is not None:
        h = weights.shape[1]
        msg = (msg.view(msg.shape[0], h, -1) * weights[:, :, None]).reshape(
            msg.shape)
    return segment_sum_ref(msg, edge_src, edge_mask, num_src)
