"""The yardstick's shared arithmetic: the padded block shapes of a batch,
each layer's widths, and each kernel's bytes and operations, worked out
from a cell's configuration and traffic (and, for the kernels, from the
live edge counts of the batches the check decoded), never from the
program's objects. An architecture's plug-in (``gnnbench/archs/``) adds
its model's FLOPs a step and which kernels it launches. The peaks are in
``peaks.json``."""
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


def layer_widths(model_cfg: dict, heads: int = 1) -> list:
    """[(d_in, d_out)] of every layer, input layer first: ``hidden_dim``
    wide, ``num_classes`` at the last layer, each d_out ``heads`` x (width
    // heads) (at least one column a head)."""
    widths, d_in = [], int(model_cfg["in_dim"])
    layers = int(model_cfg["num_layers"])
    for l in range(layers):
        d_out = int(model_cfg["num_classes"] if l == layers - 1
                    else model_cfg["hidden_dim"])
        d_out = heads * max(d_out // heads, 1)
        widths.append((d_in, d_out))
        d_in = d_out
    return widths


def gemm_flops(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def staged_shapes(model_cfg: dict, batch_size: int, trainers: int) -> dict:
    """The shapes the port stages a step of homogeneous blocks at: the
    input features (trainers, layer 0's source slots, in_dim) and each
    layer's edge slots (trainers, cap_edge), input layer first."""
    caps = capacities(batch_size, [int(f) for f in model_cfg["fanouts"]])
    return {"input_feats": (trainers, caps[0][0], int(model_cfg["in_dim"])),
            "edges": [(trainers, c[1]) for c in caps]}


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
