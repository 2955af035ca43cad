"""GAT (H heads), as the benchmark knows it: its widths and weights, its
FLOPs and kernels a step, the shapes the port stages it at, the port's
configuration of it, and its plain float32 reference.

    e_uv = leaky_relu(a_l . W h_u + a_r . W h_v, 0.2),
    alpha = softmax over v's in-edges,
    h_v' = act(concat_h sum_u alpha_uv W_h h_u + b),

with ELU on the hidden layers and none on the last, then a linear head
where the last layer's H x d_h is not the class count (DistDGLv2 §6).
Imports nothing of the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import counts
from ..reference import model as ref

staged_shapes = counts.staged_shapes


def layer_widths(model: dict) -> list:
    """[(d_in, d_out)] of every layer; d_out is heads x (width // heads)."""
    return counts.layer_widths(model, int(model["num_heads"]))


def weight_shapes(model: dict) -> dict:
    """``{"layers": [{"w" (d_in, H, d_h), "a_l", "a_r", "b"}], "head"?}``
    as shapes, in the port's layout and leaf order."""
    heads = int(model["num_heads"])
    layers = [{"w": (d_in, heads, d_out // heads),
               "a_l": (heads, d_out // heads),
               "a_r": (heads, d_out // heads), "b": (d_out,)}
              for d_in, d_out in layer_widths(model)]
    tree = {"layers": layers}
    d_last = layer_widths(model)[-1][1]
    if d_last != int(model["num_classes"]):
        tree["head"] = (d_last, int(model["num_classes"]))
    return tree


def flops_per_step(model: dict, batch_size: int, trainers: int) -> int:
    """Forward and backward FLOPs of one synchronous step at the padded
    shapes the model runs (every slot of every trainer): a layer's
    projection cap_src x d_in x (H d_h), the two head dots (cap_src and
    cap_dst rows), the scores and softmax (5 an edge and head) and the
    weighted sum (2 H d_h an edge); the head product batch x d_last x
    classes; backward, each product twice over (the weight's gradient,
    and the input's except at layer 0, whose input is features) and each
    edge reduction once more."""
    heads = int(model["num_heads"])
    caps = counts.capacities(batch_size, model["fanouts"])
    fwd = bwd = 0
    for l, ((cap_src, cap_edge, cap_dst), (d_in, d_out)) in enumerate(
            zip(caps, layer_widths(model))):
        grads_in = 2 if l > 0 else 1
        gemm = counts.gemm_flops(cap_src, d_in, d_out)
        edges = (2 * (cap_src + cap_dst) * d_out + 5 * cap_edge * heads
                 + 2 * cap_edge * d_out)
        fwd += gemm + edges
        bwd += grads_in * gemm + edges
    d_last = layer_widths(model)[-1][1]
    if d_last != int(model["num_classes"]):
        head = counts.gemm_flops(batch_size, d_last,
                                 int(model["num_classes"]))
        fwd += head
        bwd += 2 * head
    return trainers * (fwd + bwd)


def kernel_least_per_step(model: dict, batch_size: int, trainers: int,
                          live: list, peak: dict) -> dict:
    """{"fused_edge_softmax_aggregate": least seconds a step}: one K3
    forward launch a layer over all the trainers' slots, at the layer's
    output width. ``live[l]`` = (live edges, distinct live sources,
    distinct live destinations) of layer l, summed over the slots."""
    caps = counts.capacities(batch_size, model["fanouts"])
    out = {}
    for (cap_src, cap_edge, cap_dst), (d_in, d_out), (e_live, src_rows, _) \
            in zip(caps, layer_widths(model), live):
        e_slots, num_dst = trainers * cap_edge, trainers * cap_dst
        out["fused_edge_softmax_aggregate"] = out.get(
            "fused_edge_softmax_aggregate", 0.0) + counts.k3_least_seconds(
            e_slots, e_live, src_rows, num_dst, int(model["num_heads"]),
            d_out, peak)
    return out


def port_config(model: dict, batch_size: int) -> dict:
    """The keyword arguments of the port's ``GNNConfig``."""
    return dict(arch=model["arch"], in_dim=int(model["in_dim"]),
                hidden_dim=int(model["hidden_dim"]),
                num_classes=int(model["num_classes"]),
                fanouts=[int(f) for f in model["fanouts"]],
                batch_size=batch_size, num_heads=int(model["num_heads"]))


def forward(params, sample, precision="float32") -> torch.Tensor:
    """The logits of a sample's seeds (``reference/model.py`` has the
    sample's format)."""
    h = sample["feats"]
    layers = sample["layers"]
    for l, (p, blk) in enumerate(zip(params["layers"], layers)):
        n_dst, src, dst = blk["n_dst"], blk["src"], blk["dst"]
        d_in, heads, d_h = p["w"].shape
        hp = ref.matmul(h, p["w"].reshape(d_in, heads * d_h),
                        precision).view(-1, heads, d_h)
        el = (hp * p["a_l"]).sum(-1)
        er = (hp[:n_dst] * p["a_r"]).sum(-1)
        alpha = ref.edge_softmax(F.leaky_relu(el[src] + er[dst], 0.2), dst,
                                 n_dst)
        out = torch.zeros((n_dst, heads, d_h), dtype=h.dtype,
                          device=h.device).index_add_(
            0, dst, alpha[:, :, None] * hp[src])
        h = out.reshape(n_dst, heads * d_h) + p["b"]
        if l < len(layers) - 1:
            h = F.elu(h)
    if "head" in params:
        h = ref.matmul(h, params["head"], precision)
    return h
