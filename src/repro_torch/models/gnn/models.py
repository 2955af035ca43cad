"""GNN models on padded MFG mini-batches, the port of
``repro/models/gnn/models.py``. This slice ports GraphSAGE node
classification for serving; GAT and RGCN raise ``NotImplementedError``
naming their ROADMAP item.

Models are functional: ``init_gnn(cfg, generator) -> params`` and
``apply_gnn(cfg, params, batch) -> logits``, with ``params`` the
reference's tree (``{"layers": [{"w_self", "w_neigh", "b"}, ...]}``) of
tensors on one device. ``batch`` is the staged dict

    {"input_feats": (cap_src_0, F), "blocks": [block dicts...]}

optionally with a leading stack axis on every array (micro-batched
serving). The static per-layer dst capacities come from the sampler's
``capacities`` (batch_size, fanouts), the same numbers the padding used.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence

import numpy as np
import torch

from ...core.sampler.mfg import Fanout, capacities
from .layers import sage_layer

NOT_PORTED = {
    "gat": "ROADMAP queue A item 3 (GAT, with kernels K3 and K4)",
    "rgcn": "ROADMAP queue A item 4 (RGCN and the typed path)",
}


def _check_ported(arch: str) -> None:
    if arch in NOT_PORTED:
        raise NotImplementedError(f"arch {arch!r} is not ported to "
                                  f"repro_torch yet: {NOT_PORTED[arch]}")
    if arch != "graphsage":
        raise ValueError(f"unknown GNN arch {arch!r}")


@dataclasses.dataclass
class GNNConfig:
    arch: str                       # graphsage (gat | rgcn not ported yet)
    in_dim: int
    hidden_dim: int
    num_classes: int
    fanouts: Sequence[Fanout]       # input-layer first
    batch_size: int
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
        layers.append({"w_self": _glorot(generator, (d_in, d_out)),
                       "w_neigh": _glorot(generator, (d_in, d_out)),
                       "b": torch.zeros((d_out,))})
        d_in = d_out
    return params_to({"layers": layers}, device)


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
    or the same with a leading stack axis."""
    _check_ported(cfg.arch)
    last = layer == cfg.num_layers - 1
    return sage_layer(params["layers"][layer], h, block, num_dst,
                      activation=None if last else torch.relu,
                      impl=cfg.impl)


def apply_gnn(cfg: GNNConfig, params: dict, batch: dict) -> torch.Tensor:
    """Forward pass -> (batch_size, num_classes) logits (with the batch's
    stack axis in front, if it has one)."""
    h = batch["input_feats"]
    dst_caps = cfg.dst_caps()
    for l, block in enumerate(batch["blocks"]):
        h = apply_gnn_layer(cfg, params, l, h, block, dst_caps[l])
    return h
