"""GNN models on padded MFG mini-batches, the port of
``repro/models/gnn/models.py``: GraphSAGE and GAT node classification with
its loss and accuracy. RGCN raises ``NotImplementedError`` naming its
ROADMAP item; the link-prediction heads wait for theirs.

Models are functional: ``init_gnn(cfg, generator) -> params`` and
``apply_gnn(cfg, params, batch) -> logits``, with ``params`` the
reference's tree of tensors on one device
(``{"layers": [{"w_self", "w_neigh", "b"}, ...]}`` for GraphSAGE,
``{"layers": [{"w", "a_l", "a_r", "b"}, ...], "head"?}`` for GAT).
``batch`` is the staged dict

    {"input_feats": (cap_src_0, F), "blocks": [block dicts...]}

optionally with a leading stack axis on every array (micro-batched
serving, and the trainers' stacked batches in training). The static
per-layer dst capacities come from the sampler's ``capacities``
(batch_size, fanouts), the same numbers the padding used.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ...core.sampler.mfg import Fanout, capacities
from .layers import _dense, gat_layer, sage_layer

PORTED = ("graphsage", "gat")
NOT_PORTED = {
    "rgcn": "ROADMAP queue A item 4 (RGCN and the typed path)",
}


def _check_ported(arch: str) -> None:
    if arch in NOT_PORTED:
        raise NotImplementedError(f"arch {arch!r} is not ported to "
                                  f"repro_torch yet: {NOT_PORTED[arch]}")
    if arch not in PORTED:
        raise ValueError(f"unknown GNN arch {arch!r}")


@dataclasses.dataclass
class GNNConfig:
    arch: str                       # graphsage | gat (rgcn not ported yet)
    in_dim: int
    hidden_dim: int
    num_classes: int
    fanouts: Sequence[Fanout]       # input-layer first
    batch_size: int
    num_heads: int = 2              # GAT (paper: 2 heads)
    impl: str = "auto"             # kernel dispatch (repro_torch.kernels.impl)

    @property
    def num_layers(self) -> int:
        return len(self.fanouts)

    def dst_caps(self) -> List[int]:
        """Static dst-node capacity per layer (input-layer first)."""
        caps = capacities(self.batch_size, self.fanouts)
        return [c[0] for c in caps[1:]] + [self.batch_size]


def _glorot(gen: torch.Generator, shape) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[-1]
    lim = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return torch.empty(shape, dtype=torch.float32).uniform_(-lim, lim,
                                                            generator=gen)


def init_gnn(cfg: GNNConfig, generator: torch.Generator,
             device="cpu") -> dict:
    """Glorot-uniform weights with the reference's limits and zero biases,
    drawn on the CPU from ``generator`` (so a seed gives the same weights
    on every device) and moved to ``device``."""
    _check_ported(cfg.arch)
    layers = []
    d_in = cfg.in_dim
    for l in range(cfg.num_layers):
        d_out = cfg.num_classes if l == cfg.num_layers - 1 else cfg.hidden_dim
        if cfg.arch == "graphsage":
            layers.append({"w_self": _glorot(generator, (d_in, d_out)),
                           "w_neigh": _glorot(generator, (d_in, d_out)),
                           "b": torch.zeros((d_out,))})
            d_in = d_out
        else:
            d_h = max(d_out // cfg.num_heads, 1)
            layers.append({
                "w": _glorot(generator, (d_in, cfg.num_heads, d_h)),
                "a_l": _glorot(generator, (cfg.num_heads, d_h)),
                "a_r": _glorot(generator, (cfg.num_heads, d_h)),
                "b": torch.zeros((cfg.num_heads * d_h,))})
            d_in = cfg.num_heads * d_h
    params = {"layers": layers}
    if cfg.arch == "gat" and d_in != cfg.num_classes:
        params["head"] = _glorot(generator, (d_in, cfg.num_classes))
    return params_to(params, device)


def params_to(tree: Any, device) -> Any:
    """The parameter tree with every tensor on ``device``."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to(v, device) for v in tree]
    return tree.to(device)


def params_from_numpy(tree: Any, device="cpu") -> Any:
    """The reference's ``init_gnn`` parameters, as numpy arrays (or
    anything ``np.asarray`` takes), -> the port's tree of tensors on
    ``device``, bytes unchanged."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return torch.tensor(np.asarray(tree), device=device)


def apply_gnn_layer(cfg: GNNConfig, params: dict, layer: int,
                    h: torch.Tensor, block: dict,
                    num_dst: int) -> torch.Tensor:
    """One layer of the forward pass: (cap_src, d_in) -> (num_dst, d_out),
    or the same with a leading stack axis. The last layer has no
    activation; the others ReLU (GraphSAGE) or ELU (GAT)."""
    _check_ported(cfg.arch)
    last = layer == cfg.num_layers - 1
    p = params["layers"][layer]
    if cfg.arch == "gat":
        return gat_layer(p, h, block, num_dst,
                         activation=None if last else F.elu, impl=cfg.impl)
    return sage_layer(p, h, block, num_dst,
                      activation=None if last else torch.relu,
                      impl=cfg.impl)


def apply_gnn(cfg: GNNConfig, params: dict, batch: dict) -> torch.Tensor:
    """Forward pass -> (batch_size, num_classes) logits (with the batch's
    stack axis in front, if it has one)."""
    h = batch["input_feats"]
    dst_caps = cfg.dst_caps()
    for l, block in enumerate(batch["blocks"]):
        h = apply_gnn_layer(cfg, params, l, h, block, dst_caps[l])
    if "head" in params:
        out = _dense(h if h.dim() == 3 else h[None], params["head"])
        h = out if h.dim() == 3 else out[0]
    return h


# ---------------------------------------------------------------------------
# heads / losses
# ---------------------------------------------------------------------------

def nc_loss(logits: torch.Tensor, labels: torch.Tensor,
            seed_mask: torch.Tensor) -> torch.Tensor:
    """Masked cross-entropy over real (non-padded) seeds: logits (..., B,
    C), labels and seed_mask (..., B) -> one loss per leading index."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    m = seed_mask.to(torch.float32)
    return (nll * m).sum(-1) / torch.clamp_min(m.sum(-1), 1.0)


def nc_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                seed_mask: torch.Tensor) -> torch.Tensor:
    """Masked accuracy over real seeds, one per leading index."""
    pred = logits.argmax(dim=-1)
    m = seed_mask.to(torch.float32)
    return ((pred == labels.long()) * m).sum(-1) / torch.clamp_min(
        m.sum(-1), 1.0)
