"""GraphSAGE (mean), as the benchmark knows it: its widths and weights,
its FLOPs and kernels a step, the shapes the port stages it at, the
port's configuration of it, and its plain float32 reference.

    h_v' = act(W_self h_v + W_neigh mean_{u in N(v)} h_u + b)

with ReLU on the hidden layers and none on the last (DistDGLv2 §6).
Imports nothing of the program.
"""
from __future__ import annotations

import torch

from .. import counts
from ..reference import model as ref

layer_widths = counts.layer_widths
staged_shapes = counts.staged_shapes


def weight_shapes(model: dict) -> dict:
    """``{"layers": [{"w_self", "w_neigh", "b"}]}`` as shapes, in the
    port's layout and leaf order."""
    return {"layers": [{"w_self": (d_in, d_out), "w_neigh": (d_in, d_out),
                        "b": (d_out,)}
                       for d_in, d_out in layer_widths(model)]}


def flops_per_step(model: dict, batch_size: int, trainers: int) -> int:
    """Forward and backward FLOPs of one synchronous step at the padded
    shapes the model runs (every slot of every trainer): a layer's two
    products cap_dst x d_in x d_out (self, neigh) and its mean over
    cap_edge slots (cap_edge x d_in adds, cap_dst x d_in divisions);
    backward, each product twice over (the weight's gradient, and the
    input's except at layer 0, whose input is features) and the mean
    once more."""
    caps = counts.capacities(batch_size, model["fanouts"])
    fwd = bwd = 0
    for l, ((cap_src, cap_edge, cap_dst), (d_in, d_out)) in enumerate(
            zip(caps, layer_widths(model))):
        grads_in = 2 if l > 0 else 1
        gemm = 2 * counts.gemm_flops(cap_dst, d_in, d_out)
        edges = cap_edge * d_in + cap_dst * d_in
        fwd += gemm + edges
        bwd += grads_in * gemm + edges
    return trainers * (fwd + bwd)


def kernel_least_per_step(model: dict, batch_size: int, trainers: int,
                          live: list, peak: dict) -> dict:
    """{"fused_gather_aggregate": least seconds a step}: one K1 launch a
    layer over all the trainers' slots, at the layer's input width.
    ``live[l]`` = (live edges, distinct live sources, distinct live
    destinations) of layer l, summed over the slots."""
    caps = counts.capacities(batch_size, model["fanouts"])
    out = {}
    for (cap_src, cap_edge, cap_dst), (d_in, d_out), (e_live, src_rows, _) \
            in zip(caps, layer_widths(model), live):
        e_slots, num_dst = trainers * cap_edge, trainers * cap_dst
        out["fused_gather_aggregate"] = out.get(
            "fused_gather_aggregate", 0.0) + counts.k1_least_seconds(
            e_slots, e_live, src_rows, num_dst, d_in, peak)
    return out


def port_config(model: dict, batch_size: int) -> dict:
    """The keyword arguments of the port's ``GNNConfig``."""
    return dict(arch=model["arch"], in_dim=int(model["in_dim"]),
                hidden_dim=int(model["hidden_dim"]),
                num_classes=int(model["num_classes"]),
                fanouts=[int(f) for f in model["fanouts"]],
                batch_size=batch_size, num_heads=1)


def forward(params, sample, precision="float32") -> torch.Tensor:
    """The logits of a sample's seeds (``reference/model.py`` has the
    sample's format)."""
    h = sample["feats"]
    layers = sample["layers"]
    for l, (p, blk) in enumerate(zip(params["layers"], layers)):
        n_dst = blk["n_dst"]
        agg = ref.mean_aggregate(h, blk["src"], blk["dst"], n_dst)
        h = (ref.matmul(h[:n_dst], p["w_self"], precision)
             + ref.matmul(agg, p["w_neigh"], precision) + p["b"])
        if l < len(layers) - 1:
            h = torch.relu(h)
    return h
