"""GNN models on padded MFG mini-batches, the port of
``repro/models/gnn/models.py``: GraphSAGE, GAT and RGCN, the
node-classification loss and accuracy, and the link-prediction score
heads (``dot``, ``distmult``) with their loss, ranks and metrics.

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
from ...kernels import keyed_rows
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
    """The reference's parameters (``init_gnn``'s or the LM
    ``init_params``'), as numpy arrays (or anything ``np.asarray`` takes),
    -> the port's tree of tensors on ``device``, bytes unchanged. bfloat16
    arrays (``ml_dtypes.bfloat16``, which torch cannot take) travel as
    their 16-bit patterns."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.view(np.uint16), device=device).view(
            torch.bfloat16)
    return torch.tensor(a, device=device)


def apply_gnn_layer(cfg: GNNConfig, params: dict, layer: int,
                    h: torch.Tensor, block: dict, num_dst: int,
                    rel_offsets: Optional[tuple] = None,
                    row_tile: Optional[int] = None) -> torch.Tensor:
    """One layer of the forward pass: (cap_src, d_in) -> (num_dst, d_out),
    or the same with a leading stack axis. The last layer has no
    activation; the others ReLU (GraphSAGE, RGCN) or ELU (GAT).
    ``rel_offsets`` are an RGCN layer's static relation slot offsets on a
    typed block (None: the untyped layout); ``row_tile`` runs the dense
    products in calls of that many rows (:func:`~.layers._dense`)."""
    _check_arch(cfg.arch)
    last = layer == cfg.num_layers - 1
    p = params["layers"][layer]
    if cfg.arch == "gat":
        return gat_layer(p, h, block, num_dst,
                         activation=None if last else F.elu, impl=cfg.impl,
                         row_tile=row_tile)
    act = None if last else torch.relu
    if cfg.arch == "rgcn":
        return rgcn_layer(p, h, block, num_dst, cfg.num_rels,
                          activation=act, impl=cfg.impl,
                          rel_offsets=rel_offsets, row_tile=row_tile)
    return sage_layer(p, h, block, num_dst, activation=act, impl=cfg.impl,
                      row_tile=row_tile)


def apply_head(params: dict, h: torch.Tensor,
               row_tile: Optional[int] = None) -> torch.Tensor:
    """GAT's shared output ``head`` on the last layer's rows (with or
    without the stack axis); the rows unchanged where there is none."""
    if "head" not in params:
        return h
    out = _dense(h if h.dim() == 3 else h[None], params["head"], row_tile)
    return out if h.dim() == 3 else out[0]


def apply_gnn(cfg: GNNConfig, params: dict, batch: dict,
              etype_id=None, row_tile: Optional[int] = None) -> torch.Tensor:
    """Forward pass -> (batch_size, num_classes) logits (with the batch's
    stack axis in front, if it has one). On a typed config the relation
    slot offsets come from ``cfg`` (``etype_id`` resolves name-keyed
    fanouts), never from the batch. ``row_tile`` as in
    :func:`apply_gnn_layer`."""
    h = batch["input_feats"]
    dst_caps = cfg.dst_caps()
    rel_offs = (cfg.layer_rel_offsets(etype_id) if cfg.typed
                else [None] * cfg.num_layers)
    for l, block in enumerate(batch["blocks"]):
        h = apply_gnn_layer(cfg, params, l, h, block, dst_caps[l],
                            rel_offsets=rel_offs[l], row_tile=row_tile)
    return apply_head(params, h, row_tile)


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


# ---------------------------------------------------------------------------
# link prediction: score heads, loss, ranks, metrics
# ---------------------------------------------------------------------------

LP_SCORE_FNS = ("dot", "distmult")


def init_lp_head(score_fn: str, num_rels: int, emb_dim: int,
                 device="cpu") -> dict:
    """Scoring-head parameters. ``dot`` is parameter-free; ``distmult``
    owns one diagonal relation embedding per relation, initialized to ones
    so training starts exactly at the dot-product score."""
    if score_fn == "dot":
        return {}
    if score_fn == "distmult":
        return {"rel_emb": torch.ones((num_rels, emb_dim),
                                      dtype=torch.float32, device=device)}
    raise ValueError(f"unknown score_fn {score_fn!r}; have {LP_SCORE_FNS}")


def lp_pair_scores(h: torch.Tensor, u_idx: torch.Tensor, v_idx: torch.Tensor,
                   head: Optional[dict] = None, score_fn: str = "dot",
                   etypes: Optional[torch.Tensor] = None,
                   impl: str = "auto") -> torch.Tensor:
    """Edge scores from node embeddings: h (N, d); u_idx (B,); v_idx (B,)
    -> (B,) scores, or (B, K) -> (B, K) (negatives); or all of them with a
    leading stack axis S (each slot indexes its own rows of h).
    ``distmult`` scores ``<h_u, diag(r_e), h_v>`` with ``r_e =
    rel_emb[etypes]``."""
    if score_fn not in LP_SCORE_FNS:
        raise ValueError(f"unknown score_fn {score_fn!r}; have "
                         f"{LP_SCORE_FNS}")
    stacked = h.dim() == 3
    if not stacked:
        h, u_idx, v_idx = h[None], u_idx[None], v_idx[None]
        etypes = None if etypes is None else etypes[None]
    s, n, d = h.shape
    flat = h.reshape(s * n, d)
    base = torch.arange(s, device=h.device)[:, None] * n        # (S, 1)
    hu = keyed_rows(flat, u_idx.long() + base, impl)             # (S, B, d)
    if score_fn == "distmult":
        hu = hu * keyed_rows(head["rel_emb"], etypes, impl)
    vbase = base if v_idx.dim() == 2 else base[:, :, None]
    hv = keyed_rows(flat, v_idx.long() + vbase, impl)
    if hv.dim() == hu.dim() + 1:
        out = (hu[:, :, None, :] * hv).sum(-1)                   # (S, B, K)
    else:
        out = (hu * hv).sum(-1)                                  # (S, B)
    return out if stacked else out[0]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # the reference's log(1 + e^x) = logaddexp(x, 0); F.softplus returns x
    # past its threshold, with a gradient of exactly 1 there
    return torch.logaddexp(x, torch.zeros_like(x))


def lp_loss_from_scores(pos: torch.Tensor, neg: torch.Tensor,
                        pair_mask: torch.Tensor) -> torch.Tensor:
    """BCE over (..., B) positive and (..., B, K) negative scores, masked to
    live positive slots -> one loss per leading index."""
    m = pair_mask.to(torch.float32)
    pos_l = _softplus(-pos) * m
    neg_l = (_softplus(neg) * m[..., None]).mean(-1)
    return (pos_l + neg_l).sum(-1) / torch.clamp_min(m.sum(-1), 1.0)


def lp_loss(h: torch.Tensor, pos_u: torch.Tensor, pos_v: torch.Tensor,
            neg_v: torch.Tensor, pair_mask: torch.Tensor,
            impl: str = "auto") -> torch.Tensor:
    """Link-prediction BCE with dot-product scores: h (N, d) output
    embeddings; pos_u/pos_v (P,) indices into h; neg_v (P, K)."""
    pos = lp_pair_scores(h, pos_u, pos_v, impl=impl)
    neg = lp_pair_scores(h, pos_u, neg_v, impl=impl)
    return lp_loss_from_scores(pos, neg, pair_mask)


def lp_ranks(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """Pessimistic rank of each positive among its 1+K candidates: ties
    count against the positive."""
    return (1 + (neg >= pos[..., None]).sum(-1)).to(torch.int32)


def lp_metrics(ranks: torch.Tensor, pair_mask: torch.Tensor,
               ks: Sequence[int] = (1, 3, 10)) -> dict:
    """MRR and Hits@k over live positive slots, one per leading index."""
    m = pair_mask.to(torch.float32)
    n = torch.clamp_min(m.sum(-1), 1.0)
    out = {"mrr": (m / ranks).sum(-1) / n}
    for k in ks:
        out[f"hits@{k}"] = ((ranks <= k) * m).sum(-1) / n
    return out
