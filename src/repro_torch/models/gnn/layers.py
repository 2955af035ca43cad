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
chunk. The trainer stacks its T trainers' batches on the same axis.

On the card every reduction over edges, forward and backward, is a kernel
that sums in a fixed order, so two runs of a training step give the same
bytes.

The dense products take ``row_tile``: None runs one product over all rows;
an int T runs them in calls of exactly T rows (the last padded with
zeros), so a row's bytes never depend on how many rows share the call.
BLAS libraries on the CPU and the card pick their kernel, and with it the
order of a row's sums, by the product's shape; the layer-wise pass
(:func:`~repro_torch.api.offline_embeddings`) needs the same bytes for a
node at any chunk size.
"""
from __future__ import annotations

import torch

import torch.nn.functional as F

from ...kernels import (dst_groups, fused_edge_softmax_aggregate,
                        fused_gather_aggregate, gather_edges, segment_sum,
                        src_groups)
from ...kernels.impl import resolve_impl


def _degrees(edge_dst, edge_mask, num_dst, impl="auto", groups=None):
    ones = edge_mask.to(torch.float32)[:, None]
    deg = segment_sum(ones, edge_dst, edge_mask, num_dst, impl=impl,
                      groups=groups)[:, 0]
    return torch.clamp_min(deg, 1.0)


def _flat_edges(block: dict, num_slots: int, cap_src: int, num_dst: int):
    """(S, E) edge arrays (or (E,) with one slot) -> (S*E,) arrays indexing
    the flat (S*cap_src) sources and (S*num_dst) destinations."""
    slot = torch.arange(num_slots, dtype=torch.int32,
                        device=block["edge_src"].device)[:, None]
    edge_src = block["edge_src"].reshape(num_slots, -1).to(torch.int32)
    edge_dst = block["edge_dst"].reshape(num_slots, -1).to(torch.int32)
    return ((edge_src + slot * cap_src).reshape(-1),
            (edge_dst + slot * num_dst).reshape(-1),
            block["edge_mask"].reshape(-1))


def _dense(x: torch.Tensor, w: torch.Tensor, row_tile=None) -> torch.Tensor:
    """(S, N, d_in) @ (d_in, d_out): one identical product per slot, or,
    with ``row_tile`` T, products of exactly T rows over the S*N rows."""
    if row_tile is None:
        return torch.bmm(x, w.expand(x.shape[0], -1, -1))
    s, n, d_in = x.shape
    rows = x.reshape(s * n, d_in)
    pad = -rows.shape[0] % row_tile
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad, d_in))])
    out = torch.cat([torch.mm(t, w) for t in rows.split(row_tile)])
    return out[:s * n].view(s, n, w.shape[-1])


def _head_dot(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(S, N, H, d_h) . (H, d_h) -> (S, N, H): each head's dot product, as
    a product and a sum over d_h, so that every row is reduced alike
    whatever the stack size (an ``einsum`` picks its reduction by shape)."""
    return (x * a).sum(-1)


def sage_layer(params, h_src: torch.Tensor, block: dict, num_dst: int,
               activation=torch.relu, impl: str = "auto",
               row_tile=None) -> torch.Tensor:
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
    out = (_dense(h_self, params["w_self"], row_tile)
           + _dense(agg.view(s, num_dst, f), params["w_neigh"], row_tile)
           + params["b"])
    if activation is not None:
        out = activation(out)
    return out if stacked else out[0]


def gat_attention_inputs(params, h_src: torch.Tensor, block: dict,
                         num_dst: int, row_tile=None):
    """The GAT layer up to its attention tail, with the stack axis S (1
    without one) flattened into the rows: (h_proj (S*V, H, d_h), el
    (S*V, H), er (S*num_dst, H), edge_src, edge_dst, edge_mask (S*E,))."""
    h = h_src if h_src.dim() == 3 else h_src[None]
    s, v, f = h.shape
    w = params["w"]
    heads, d_h = w.shape[1], w.shape[2]
    edge_src, edge_dst, edge_mask = _flat_edges(block, s, v, num_dst)
    h_proj = _dense(h, w.reshape(f, heads * d_h), row_tile).view(
        s, v, heads, d_h)
    el = _head_dot(h_proj, params["a_l"]).reshape(s * v, heads)
    er = _head_dot(h_proj[:, :num_dst], params["a_r"]).reshape(
        s * num_dst, heads)
    return (h_proj.view(s * v, heads, d_h), el, er, edge_src, edge_dst,
            edge_mask)


def gat_layer(params, h_src: torch.Tensor, block: dict, num_dst: int,
              activation=F.elu, impl: str = "auto",
              negative_slope: float = 0.2, row_tile=None) -> torch.Tensor:
    """GAT layer, multi-head concat. params: w (d_in, H, d_h), a_l/a_r
    (H, d_h), b (H*d_h,)."""
    stacked = h_src.dim() == 3
    s = h_src.shape[0] if stacked else 1
    h_proj, el, er, edge_src, edge_dst, edge_mask = gat_attention_inputs(
        params, h_src, block, num_dst, row_tile)
    n = s * num_dst
    if resolve_impl(impl, h_src) == "cuda":
        # one destination order for the scores' gather, K4 and K3, and one
        # source order for the backward reductions into source rows
        by_dst = dst_groups(edge_dst, edge_mask, n)
        by_src = (src_groups(edge_src, edge_mask, h_proj.shape[0])
                  if torch.is_grad_enabled() else None)
        scores = (gather_edges(el, edge_src, edge_mask, by_src)
                  + gather_edges(er, edge_dst, edge_mask, by_dst))
    else:
        by_dst = by_src = None
        scores = (el.index_select(0, edge_src.long())
                  + er.index_select(0, edge_dst.long()))
    scores = F.leaky_relu(scores, negative_slope)
    # fused softmax -> weighted gather -> aggregate (attention tail)
    out = fused_edge_softmax_aggregate(h_proj, scores, edge_src, edge_dst,
                                       edge_mask, n, impl=impl,
                                       groups=by_dst, by_src=by_src)
    out = out.view(s, num_dst, -1) + params["b"]
    if activation is not None:
        out = activation(out)
    return out if stacked else out[0]


def rgcn_relation_edges(block: dict, num_slots: int, cap_src: int,
                        num_dst: int, r: int, rel_offsets=None):
    """Relation r's edges of a block with ``num_slots`` stack slots, as
    :func:`_flat_edges` flattens them, or None where a typed layer has no
    slot for r. Typed: the static slot range ``[rel_offsets[r],
    rel_offsets[r+1])`` of every stack slot's edge arrays, cut before the
    slots are flattened so that each slot's indices are offset as its own.
    Untyped: every edge, masked to ``edge_types == r``."""
    if rel_offsets is None:
        edge_src, edge_dst, edge_mask = _flat_edges(block, num_slots, cap_src,
                                                    num_dst)
        return (edge_src, edge_dst,
                edge_mask & (block["edge_types"].reshape(-1) == r))
    lo, hi = int(rel_offsets[r]), int(rel_offsets[r + 1])
    if hi == lo:
        return None
    cut = {k: block[k].reshape(num_slots, -1)[:, lo:hi]
           for k in ("edge_src", "edge_dst", "edge_mask")}
    return _flat_edges(cut, num_slots, cap_src, num_dst)


def rgcn_layer(params, h_src: torch.Tensor, block: dict, num_dst: int,
               num_rels: int, activation=torch.relu, impl: str = "auto",
               rel_offsets=None, row_tile=None) -> torch.Tensor:
    """RGCN: h_v = act(W_0 h_v + sum_r (1/c_{v,r}) sum_{u in N_r(v)} W_r h_u).

    params: w_rel (R, d_in, d_out), w_self (d_in, d_out), b (d_out,).
    Relations are looped (R is small and static). Two block layouts:

    * typed (relation-major, ``rel_offsets`` a static (R+1,) tuple from the
      sampler's per-relation capacities): relation r's edges occupy the
      static slot range ``[rel_offsets[r], rel_offsets[r+1])`` of every
      stack slot, so each relation's sums run over only its own slots; a
      relation with an empty range is skipped;
    * untyped: one fused edge axis, each relation re-scans it with its own
      ``edge_types == r`` mask.

    Each relation projects all source rows, ``h_src @ w_rel[r]``, sums them
    with K1 and divides by its own degrees (K2); on the card K1 and K2
    share one destination-grouped order per relation.
    """
    stacked = h_src.dim() == 3
    h = h_src if stacked else h_src[None]
    s, v, _f = h.shape
    n = s * num_dst
    on_card = resolve_impl(impl, h) == "cuda"
    out = _dense(h[:, :num_dst], params["w_self"], row_tile) + params["b"]
    for r in range(num_rels):
        edges = rgcn_relation_edges(block, s, v, num_dst, r, rel_offsets)
        if edges is None:             # relation not sampled at this layer
            continue
        es, ed, em = edges
        proj = _dense(h, params["w_rel"][r], row_tile)   # (S, cap_src, d_out)
        d_out = proj.shape[-1]
        groups = dst_groups(ed, em, n) if on_card else None
        agg = fused_gather_aggregate(proj.reshape(s * v, d_out), es, ed, em,
                                     n, impl=impl, groups=groups)
        agg = agg / _degrees(ed, em, n, impl=impl, groups=groups)[:, None]
        out = out + agg.view(s, num_dst, d_out)
    if activation is not None:
        out = activation(out)
    return out if stacked else out[0]
