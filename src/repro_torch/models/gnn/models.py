"""GNN models on padded MFG mini-batches, the port of
``repro/models/gnn/models.py``: GraphSAGE, GAT and RGCN node
classification with its loss and accuracy. The link-prediction heads wait
for their ROADMAP item.

Models are functional: ``init_gnn(cfg, generator) -> params`` and
``apply_gnn(cfg, params, batch, etype_id) -> logits``, with ``params`` the
reference's tree of tensors on one device
(``{"layers": [{"w_self", "w_neigh", "b"}, ...]}`` for GraphSAGE,
``{"layers": [{"w", "a_l", "a_r", "b"}, ...], "head"?}`` for GAT,
``{"layers": [{"w_rel", "w_self", "b"}, ...]}`` for RGCN).
``batch`` is the staged dict

    {"input_feats": (cap_src_0, F), "blocks": [block dicts...]}

optionally with a leading stack axis on every array (micro-batched
serving, and the trainers' stacked batches in training). The static
per-layer dst capacities come from the sampler's ``capacities``
(batch_size, fanouts), the same numbers the padding used.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ...core.sampler.mfg import Fanout, capacities, relation_capacities
from .layers import _dense, gat_layer, rgcn_layer, sage_layer

ARCHS = ("graphsage", "gat", "rgcn")


def _check_arch(arch: str) -> None:
    if arch not in ARCHS:
        raise ValueError(f"unknown GNN arch {arch!r}; have {ARCHS}")


@dataclasses.dataclass
class GNNConfig:
    arch: str                       # graphsage | gat | rgcn
    in_dim: int
    hidden_dim: int
    num_classes: int
    fanouts: Sequence[Fanout]       # input-layer first; int or {etype: f}
    batch_size: int
    num_heads: int = 2              # GAT (paper: 2 heads)
    num_rels: int = 1               # RGCN
    impl: str = "auto"             # kernel dispatch (repro_torch.kernels.impl)

    @property
    def num_layers(self) -> int:
        return len(self.fanouts)

    @property
    def typed(self) -> bool:
        """Any layer with per-relation fanouts => relation-major blocks."""
        return any(isinstance(f, Mapping) for f in self.fanouts)

    def dst_caps(self) -> List[int]:
        """Static dst-node capacity per layer (input-layer first)."""
        caps = capacities(self.batch_size, self.fanouts)
        return [c[0] for c in caps[1:]] + [self.batch_size]

    def layer_rel_offsets(self, etype_id=None) -> List[Optional[tuple]]:
        """Static per-layer relation slot offsets (input-layer first);
        None entries for untyped layers. Mapping keys are relation IDs by
        default; pass a schema's ``etype_id`` for name keys. These are the
        numbers the sampler pads with: model and sampler both derive them
        from (batch_size, fanouts)."""
        offs = relation_capacities(self.batch_size, self.fanouts,
                                   self.num_rels, etype_id=etype_id)
        return [None if o is None else tuple(int(x) for x in o)
                for o in offs]


def _glorot(gen: torch.Generator, shape) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[-1]
    lim = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return torch.empty(shape, dtype=torch.float32).uniform_(-lim, lim,
                                                            generator=gen)


def init_gnn(cfg: GNNConfig, generator: torch.Generator,
             device="cpu") -> dict:
    """Glorot-uniform weights with the reference's limits and zero biases,
    drawn on the CPU from ``generator`` (so a seed gives the same weights
    on every device) and moved to ``device``. RGCN's ``w_rel`` (R, d_in,
    d_out) takes the reference's rule: fan-in from its first axis, R, then
    divided by sqrt(R)."""
    _check_arch(cfg.arch)
    layers = []
    d_in = cfg.in_dim
    for l in range(cfg.num_layers):
        d_out = cfg.num_classes if l == cfg.num_layers - 1 else cfg.hidden_dim
        if cfg.arch == "graphsage":
            layers.append({"w_self": _glorot(generator, (d_in, d_out)),
                           "w_neigh": _glorot(generator, (d_in, d_out)),
                           "b": torch.zeros((d_out,))})
            d_in = d_out
        elif cfg.arch == "rgcn":
            w_rel = _glorot(generator, (cfg.num_rels, d_in, d_out))
            layers.append({"w_rel": w_rel / float(np.sqrt(cfg.num_rels)),
                           "w_self": _glorot(generator, (d_in, d_out)),
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
                    h: torch.Tensor, block: dict, num_dst: int,
                    rel_offsets: Optional[tuple] = None) -> torch.Tensor:
    """One layer of the forward pass: (cap_src, d_in) -> (num_dst, d_out),
    or the same with a leading stack axis. The last layer has no
    activation; the others ReLU (GraphSAGE, RGCN) or ELU (GAT).
    ``rel_offsets`` are an RGCN layer's static relation slot offsets on a
    typed block (None: the untyped layout)."""
    _check_arch(cfg.arch)
    last = layer == cfg.num_layers - 1
    p = params["layers"][layer]
    if cfg.arch == "gat":
        return gat_layer(p, h, block, num_dst,
                         activation=None if last else F.elu, impl=cfg.impl)
    act = None if last else torch.relu
    if cfg.arch == "rgcn":
        return rgcn_layer(p, h, block, num_dst, cfg.num_rels,
                          activation=act, impl=cfg.impl,
                          rel_offsets=rel_offsets)
    return sage_layer(p, h, block, num_dst, activation=act, impl=cfg.impl)


def apply_gnn(cfg: GNNConfig, params: dict, batch: dict,
              etype_id=None) -> torch.Tensor:
    """Forward pass -> (batch_size, num_classes) logits (with the batch's
    stack axis in front, if it has one). On a typed config the relation
    slot offsets come from ``cfg`` (``etype_id`` resolves name-keyed
    fanouts), never from the batch."""
    h = batch["input_feats"]
    dst_caps = cfg.dst_caps()
    rel_offs = (cfg.layer_rel_offsets(etype_id) if cfg.typed
                else [None] * cfg.num_layers)
    for l, block in enumerate(batch["blocks"]):
        h = apply_gnn_layer(cfg, params, l, h, block, dst_caps[l],
                            rel_offsets=rel_offs[l])
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
