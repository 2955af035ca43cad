"""Mixture-of-Experts FFN; the port of ``repro.models.lm.moe``'s local
formulation.

``_moe_local``: top-k routing -> flatten the (T·k) assignments -> stable
sort by expert -> one grouped product per non-empty expert over its
contiguous rows (``jax.lax.ragged_dot``'s groups) -> unsort by a
permutation write -> weighted combine. No (T, E, C) one-hot dispatch
tensor is materialized. On one device the reference's ``moe_block`` takes
this formulation too; its sharded forms wait for the port of the sharding
rules.

Aux load-balance loss follows Switch/GShard: E · Σ_e f_e · p_e.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _route(xt: torch.Tensor, router: torch.Tensor, k: int):
    """xt: (T, d) -> (top_p (T,k) f32-normalized, top_i (T,k), probs).
    Ties go to the lower expert index, as ``jax.lax.top_k`` breaks them."""
    logits = (xt.to(router.dtype) @ router).float()
    probs = torch.softmax(logits, dim=-1)
    top_i = torch.argsort(probs, dim=-1, descending=True, stable=True)[:, :k]
    top_p = probs.gather(-1, top_i)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p, top_i, probs


def _aux_loss(probs: torch.Tensor, top_i: torch.Tensor, e: int):
    frac_tokens = F.one_hot(top_i, e).float().mean(dim=(0, 1))
    mean_prob = probs.mean(dim=0)
    return e * torch.sum(frac_tokens * mean_prob)


def _grouped(xs: torch.Tensor, w: torch.Tensor, sizes: list) -> torch.Tensor:
    """``ragged_dot``: rows of group e (contiguous, ``sizes[e]`` of them)
    times ``w[e]``; groups with no row cost nothing."""
    out = xs.new_empty((xs.shape[0], w.shape[-1]))
    start = 0
    for e, size in enumerate(sizes):
        if size:
            out[start:start + size] = xs[start:start + size] @ w[e]
            start += size
    return out


def _moe_local(p: dict, x: torch.Tensor, cfg):
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_tok
    xt = x.reshape(b * s, d)
    t = xt.shape[0]
    top_p, top_i, probs = _route(xt, p["router"], k)
    top_p = top_p.to(x.dtype)

    flat_expert = top_i.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    xs = xt.index_select(0, order // k)
    sizes = torch.bincount(flat_expert, minlength=e).tolist()

    h = F.silu(_grouped(xs, p["experts_gate"], sizes))
    h = h * _grouped(xs, p["experts_up"], sizes)
    y = _grouped(h, p["experts_down"], sizes)

    y_unsorted = torch.empty_like(y).index_copy_(0, order, y)
    out = torch.einsum("tkd,tk->td", y_unsorted.reshape(t, k, d), top_p)
    return out.reshape(b, s, d), _aux_loss(probs, top_i, e)


def moe_block(p: dict, x: torch.Tensor, cfg) -> tuple:
    """x: (B, S, d) -> (out, aux_loss). params: router (d, E) float32,
    experts_gate/experts_up (E, d, ff), experts_down (E, ff, d)."""
    return _moe_local(p, x, cfg)
