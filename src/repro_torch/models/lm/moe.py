"""Mixture-of-Experts FFN; the port of ``repro.models.lm.moe``'s local
formulation.

``_moe_local``: top-k routing -> flatten the (T·k) assignments -> stable
sort by expert -> the grouped product (``jax.lax.ragged_dot``'s groups)
-> unsort by a permutation write -> weighted combine. No (T, E, C)
one-hot dispatch tensor is materialized. The grouped product writes each
expert's rows into a bucket of the fullest expert's length and takes one
batched product over the buckets: three launches a layer, not three an
expert, and one host sync a layer for the bucket length. On one device the reference's ``moe_block`` takes
this formulation too; its sharded forms wait for the port of the sharding
rules.

Each token row is gathered once for each of its k experts
(:func:`~repro_torch.kernels.keyed_rows`): on the card the gradient of
that gather is K2 over the token ids in a fixed order, not float atomics.

Aux load-balance loss follows Switch/GShard: E · Σ_e f_e · p_e.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...kernels import keyed_rows


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


def _buckets(sorted_expert: torch.Tensor, e: int) -> tuple:
    """Rows sorted by expert -> (their expert, their slot in its bucket,
    the bucket length: the most rows any expert has)."""
    counts = torch.bincount(sorted_expert, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    slot = (torch.arange(sorted_expert.numel(), device=counts.device)
            - starts[sorted_expert])
    return sorted_expert, slot, int(counts.max())


def _grouped(xs: torch.Tensor, w: torch.Tensor, buckets: tuple
             ) -> torch.Tensor:
    """``ragged_dot``: each row of ``xs`` (sorted by expert) times its
    expert's ``w[e]``, as one batched product over zero-padded buckets."""
    expert, slot, cap = buckets
    buf = xs.new_zeros((w.shape[0], cap, xs.shape[-1]))
    buf = buf.index_put((expert, slot), xs)
    return torch.bmm(buf, w)[expert, slot]


def _moe_local(p: dict, x: torch.Tensor, cfg):
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_tok
    xt = x.reshape(b * s, d)
    t = xt.shape[0]
    top_p, top_i, probs = _route(xt, p["router"], k)
    top_p = top_p.to(x.dtype)

    flat_expert = top_i.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    xs = keyed_rows(xt, order // k)
    buckets = _buckets(flat_expert[order], e)

    h = F.silu(_grouped(xs, p["experts_gate"], buckets))
    h = h * _grouped(xs, p["experts_up"], buckets)
    y = _grouped(h, p["experts_down"], buckets)

    y_unsorted = torch.empty_like(y).index_copy_(0, order, y)
    out = torch.einsum("tkd,tk->td", y_unsorted.reshape(t, k, d), top_p)
    return out.reshape(b, s, d), _aux_loss(probs, top_i, e)


def moe_block(p: dict, x: torch.Tensor, cfg) -> tuple:
    """x: (B, S, d) -> (out, aux_loss). params: router (d, E) float32,
    experts_gate/experts_up (E, d, ff), experts_down (E, ff, d)."""
    return _moe_local(p, x, cfg)
