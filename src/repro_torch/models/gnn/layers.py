"""GNN layers over padded MFG blocks (message passing per Eq. (1)), the
port of ``repro/models/gnn/layers.py``.

Each layer consumes ``h_src`` (cap_src, d_in) -- features of the block's
input nodes, dst nodes in the prefix -- and produces ``h_dst``
(cap_dst, d_out). Aggregations run through the kernels package (CUDA on a
card, the plain versions on the CPU); padded edges are masked out of every
reduction.

A layer also takes a leading stack axis, the port's counterpart of the
reference's ``vmap`` over micro-batched chunks: ``h_src`` (S, cap_src,
d_in) and (S, cap_edge) block arrays give (S, cap_dst, d_out). The S
blocks are offset into one flat block, so each kernel launches once for
all of them, and the dense products run as one batched product whose S
items are computed alike: a slot's rows depend on nothing but its own
chunk.
"""
from __future__ import annotations

import torch

from ...kernels import dst_groups, fused_gather_aggregate, segment_sum
from ...kernels.impl import resolve_impl


def _degrees(edge_dst, edge_mask, num_dst, impl="auto", groups=None):
    ones = edge_mask.to(torch.float32)[:, None]
    deg = segment_sum(ones, edge_dst, edge_mask, num_dst, impl=impl,
                      groups=groups)[:, 0]
    return torch.clamp_min(deg, 1.0)


def _flat_edges(block: dict, num_slots: int, cap_src: int, num_dst: int):
    """(S, E) edge arrays -> (S*E,) arrays indexing the flat (S*cap_src)
    sources and (S*num_dst) destinations."""
    slot = torch.arange(num_slots, dtype=torch.int32,
                        device=block["edge_src"].device)[:, None]
    edge_src = block["edge_src"].reshape(num_slots, -1).to(torch.int32)
    edge_dst = block["edge_dst"].reshape(num_slots, -1).to(torch.int32)
    return ((edge_src + slot * cap_src).reshape(-1),
            (edge_dst + slot * num_dst).reshape(-1),
            block["edge_mask"].reshape(-1))


def _dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(S, N, d_in) @ (d_in, d_out), one identical product per slot."""
    return torch.bmm(x, w.expand(x.shape[0], -1, -1))


def sage_layer(params, h_src: torch.Tensor, block: dict, num_dst: int,
               activation=torch.relu, impl: str = "auto") -> torch.Tensor:
    """GraphSAGE mean aggregator: act(W_self h_v + W_neigh mean_u h_u)."""
    stacked = h_src.dim() == 3
    h = h_src if stacked else h_src[None]
    s, v, f = h.shape
    edge_src, edge_dst, edge_mask = _flat_edges(block, s, v, num_dst)
    n = s * num_dst
    # K1 and K2 of one layer share one destination-grouped edge order
    groups = (dst_groups(edge_dst, edge_mask, n)
              if resolve_impl(impl, h) == "cuda" else None)
    agg = fused_gather_aggregate(h.reshape(s * v, f), edge_src, edge_dst,
                                 edge_mask, n, impl=impl, groups=groups)
    agg = agg / _degrees(edge_dst, edge_mask, n, impl=impl,
                         groups=groups)[:, None]
    h_self = h[:, :num_dst]
    out = (_dense(h_self, params["w_self"])
           + _dense(agg.view(s, num_dst, f), params["w_neigh"])
           + params["b"])
    if activation is not None:
        out = activation(out)
    return out if stacked else out[0]
