"""The yardstick's arithmetic: the padded block shapes of a batch, the
model's FLOPs a step, and each kernel's bytes and operations, worked out
from a cell's configuration and traffic (and, for the kernels, from the
live edge counts of the batches the check decoded), never from the
program's objects. The peaks are in ``peaks.json``."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

_PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(kind: str) -> Optional[dict]:
    """{"fp32_flop_s", "hbm_byte_s"} of a device by its name, or None."""
    table = json.loads(_PEAKS.read_text())["devices"]
    return table.get(kind)


def capacities(batch_size: int, fanouts: list) -> list:
    """[(cap_src, cap_edge, cap_dst)] of every layer, input layer first:
    the last layer's destinations are the batch, each layer's sources
    its destinations followed by fanout slots a destination, and each
    layer's destinations the next layer's sources."""
    caps, cap_dst = [], batch_size
    for f in reversed(fanouts):
        cap_edge = cap_dst * int(f)
        caps.append((cap_dst + cap_edge, cap_edge, cap_dst))
        cap_dst = cap_dst + cap_edge
    return caps[::-1]


def layer_widths(model_cfg: dict) -> list:
    """[(d_in, d_out)] of every layer, input layer first (GAT: d_out is
    heads x (width // heads))."""
    widths, d_in = [], int(model_cfg["in_dim"])
    layers = int(model_cfg["num_layers"])
    for l in range(layers):
        d_out = int(model_cfg["num_classes"] if l == layers - 1
                    else model_cfg["hidden_dim"])
        if model_cfg["arch"] == "gat":
            heads = int(model_cfg["num_heads"])
            d_out = heads * max(d_out // heads, 1)
        widths.append((d_in, d_out))
        d_in = d_out
    return widths


def _gemm(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def model_flops_per_step(model_cfg: dict, batch_size: int,
                         num_trainers: int) -> int:
    """Forward and backward FLOPs of one synchronous step at the padded
    shapes the model runs (every slot of every trainer):

    * GraphSAGE layer: two products cap_dst x d_in x d_out (self, neigh),
      the mean over cap_edge slots (cap_edge x d_in adds, cap_dst x d_in
      divisions);
    * GAT layer: the projection cap_src x d_in x (H d_h), the two head
      dots (cap_src and cap_dst rows), the scores and softmax (5 an edge
      and head), the weighted sum (2 H d_h an edge); the head product
      batch x d_last x classes;
    * backward: each product twice over (the weight's gradient, and the
      input's except at layer 0, whose input is features), each edge
      reduction once more.
    """
    arch = model_cfg["arch"]
    caps = capacities(batch_size, model_cfg["fanouts"])
    fwd = bwd = 0
    for l, ((cap_src, cap_edge, cap_dst), (d_in, d_out)) in enumerate(
            zip(caps, layer_widths(model_cfg))):
        grads_in = 2 if l > 0 else 1
        if arch == "graphsage":
            gemm = 2 * _gemm(cap_dst, d_in, d_out)
            edges = cap_edge * d_in + cap_dst * d_in
        elif arch == "gat":
            heads = int(model_cfg["num_heads"])
            gemm = _gemm(cap_src, d_in, d_out)
            edges = (2 * (cap_src + cap_dst) * d_out + 5 * cap_edge * heads
                     + 2 * cap_edge * d_out)
        else:
            raise ValueError(f"no FLOP count for arch {arch!r}")
        fwd += gemm + edges
        bwd += grads_in * gemm + edges
    d_last = layer_widths(model_cfg)[-1][1]
    if arch == "gat" and d_last != int(model_cfg["num_classes"]):
        head = _gemm(batch_size, d_last, int(model_cfg["num_classes"]))
        fwd += head
        bwd += 2 * head
    return num_trainers * (fwd + bwd)


def least_seconds(nbytes: int, ops: int, peak: dict) -> float:
    """The least time a launch can take: its bytes over the memory
    bandwidth or its operations over the float32 peak, the larger."""
    return max(nbytes / peak["hbm_byte_s"], ops / peak["fp32_flop_s"])


def k1_least_seconds(e_slots: int, e_live: int, src_rows: int,
                     num_dst: int, f: int, peak: dict) -> float:
    """``fused_gather_aggregate`` (sum of the source rows of each
    destination's live edges): the mask byte of every slot, both 4-byte
    indices of each live edge, each referenced source row once and the
    whole output, in float32; one add an edge and column."""
    nbytes = e_slots + e_live * 8 + src_rows * f * 4 + num_dst * f * 4
    return least_seconds(nbytes, e_live * f, peak)


def k3_least_seconds(e_slots: int, e_live: int, src_rows: int,
                     num_dst: int, heads: int, f: int,
                     peak: dict) -> float:
    """``fused_edge_softmax_aggregate``'s forward (the attention-weighted
    sum, given the softmax statistics): the mask byte of every slot, both
    indices and the H scores of each live edge, the statistics m and z of
    every destination, each referenced source row once and the output;
    2 f + 3 H operations an edge (f = H x d_h)."""
    nbytes = (e_slots + e_live * 8 + e_live * heads * 4
              + 2 * num_dst * heads * 4 + src_rows * f * 4
              + num_dst * f * 4)
    return least_seconds(nbytes, e_live * (2 * f + 3 * heads), peak)


def kernel_least_per_step(model_cfg: dict, batch_size: int,
                          num_trainers: int, live: list,
                          peak: dict) -> dict:
    """{kernel: least seconds a step}, one launch a layer over all the
    trainers' slots. ``live[l]`` = (live edges, distinct live sources,
    distinct live destinations) of layer l, summed over the slots."""
    caps = capacities(batch_size, model_cfg["fanouts"])
    out = {}
    for (cap_src, cap_edge, cap_dst), (d_in, d_out), (e_live, src_rows, _) \
            in zip(caps, layer_widths(model_cfg), live):
        e_slots, num_dst = num_trainers * cap_edge, num_trainers * cap_dst
        if model_cfg["arch"] == "graphsage":
            out["fused_gather_aggregate"] = out.get(
                "fused_gather_aggregate", 0.0) + k1_least_seconds(
                e_slots, e_live, src_rows, num_dst, d_in, peak)
        elif model_cfg["arch"] == "gat":
            out["fused_edge_softmax_aggregate"] = out.get(
                "fused_edge_softmax_aggregate", 0.0) + k3_least_seconds(
                e_slots, e_live, src_rows, num_dst,
                int(model_cfg["num_heads"]), d_out, peak)
    return out
