"""Transformer building blocks: RMSNorm, RoPE, GQA attention (query-chunked
for prefill; ring-buffer cache for decode), SwiGLU / GeLU MLP. The port of
``repro.models.lm.layers``.

All attention paths support grouped-query attention (num_kv_heads <
num_heads; head h reads KV head h // g), optional per-head q/k RMSNorm
(qwen3) and QKV bias (qwen2), and optional sliding-window masking.

Every cast mirrors the reference's: scores are divided by sqrt(d) in the
inputs' dtype (sqrt(d) rounded to it first, as JAX rounds a scalar to the
array's dtype), then taken to float32 for the masked softmax, whose
probabilities return to the inputs' dtype before the value product.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor

from ...sharding.collectives import axis_index, pmax, psum
from ...sharding.rules import (_active_mesh, current_rules, local_call,
                               fit, is_split, mm, reshape, spec,
                               spec_of)

NEG_INF = -1e30      # masked scores (float32)


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to float32 and then to ``dtype``: the scalar JAX
    divides by in that dtype."""
    return float(torch.tensor(value, dtype=torch.float32).to(dtype))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) or (S,)."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / torch.pow(
        theta, torch.arange(half, dtype=torch.float32,
                            device=x.device) / half)
    ang = positions.float()[..., None] * freqs              # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, d: Optional[int] = None,
                reduce=None) -> torch.Tensor:
    """q: (B,Sq,H,D), k: (B,Sk,KV,D) -> (B,KV,G,Sq,Sk), G = H // KV, over
    sqrt(d) (``d`` the whole head_dim, D by default). ``reduce`` sums the
    products before the division (over the ranks of a sharded head_dim)."""
    b, sq, h, dl = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, dl)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k)
    if reduce is not None:
        scores = reduce(scores)
    return scores / _in_dtype(math.sqrt(d or dl), q.dtype)


def _gqa_combine(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: (B,KV,G,Sq,Sk), v: (B,Sk,KV,D) -> (B,Sq,H,D)."""
    b, kv, g, sq, _ = probs.shape
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, kv * g, out.shape[-1])


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0, chunk: int = 1024) -> torch.Tensor:
    """Query-chunked masked attention.

    q: (B, Sq, H, D); k, v: (B, Sk, KV, D). ``q_offset`` is the absolute
    position of q[0] relative to k[0]. KV heads are repeated to the full
    H; queries go in chunks of ``chunk``, so the score matrix never
    exceeds (B, H, chunk, Sk).

    On DTensors (a mesh active), the reference's Megatron mapping: q, k
    and v are constrained to the batch over the batch axes and the heads
    over "model" (replicated under pure FSDP), and each rank attends with
    its own heads on its local shards. Where the KV heads do not divide
    over "model", k and v are replicated over it and each rank takes the
    repeated heads its query heads read."""
    g = q.shape[2] // k.shape[2]
    mesh = _active_mesh()
    if mesh is None or not isinstance(q, DTensor):
        return _attention(q, k, v, g, 0, causal, window, q_offset, chunk)
    r = current_rules()
    head_axis = None if r.pure_fsdp else r.model_axis
    hspec = fit(spec(r.batch_axes, None, head_axis, None), q.shape)
    m = 1 if head_axis is None else mesh[head_axis].size()
    head0 = 0
    kvspec = hspec
    if k.shape[2] % m:
        kvspec = spec(hspec[0], None, None, None)
        head0 = mesh[head_axis].get_local_rank() * (q.shape[2] // m)
    fn = functools.partial(_attention, g=g, head0=head0, causal=causal,
                           window=window, q_offset=q_offset, chunk=chunk)
    return local_call(fn, (hspec, kvspec, kvspec), hspec, q, k, v)


def _attention(q, k, v, g, head0, causal, window, q_offset, chunk):
    """:func:`attention` on one rank's heads: k, v's heads repeated ``g``
    times and, where they hold more than q's, those from ``head0``."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    if k.shape[2] != h:
        k, v = k[:, :, head0:head0 + h], v[:, :, head0:head0 + h]
    chunk = min(chunk, sq)
    pad = (-sq) % chunk
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
    scale = _in_dtype(math.sqrt(d), q.dtype)
    kpos = torch.arange(sk, device=q.device)
    outs = []
    for start in range(0, q.shape[1], chunk):
        qc = q[:, start:start + chunk]
        scores = (torch.einsum("bqhd,bshd->bhqs", qc, k) / scale).float()
        if causal or window is not None:
            qpos = q_offset + start + torch.arange(chunk, device=q.device)
            mask = torch.ones((chunk, sk), dtype=torch.bool, device=q.device)
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
            if window is not None:
                mask &= kpos[None, :] > qpos[:, None] - window
            scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bhqs,bshd->bqhd", probs, v))
    return torch.cat(outs, dim=1)[:, :sq]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention over a (ring-buffer) cache.

    q: (B, 1, H, D); k_cache/v_cache: (B, W, KV, D). Slot i of a ring
    buffer holds absolute position  pos - ((pos - i) mod W); slots with a
    negative implied position are unwritten and masked. For full
    (non-windowed) caches W == max_seq and the same formula masks exactly
    the > pos tail.

    On DTensors (a mesh active), the same body on each rank's shards of
    the cache as it is placed (``cache_pspecs``): q is placed to match,
    scores are summed over the ranks of a sharded head_dim, and the
    softmax and the value sum over the ranks of a sharded ring."""
    w, d = k_cache.shape[1], q.shape[-1]
    mesh = _active_mesh()
    if mesh is None or not isinstance(k_cache, DTensor):
        return _decode_attention(q, k_cache, v_cache, pos, window, w, d)
    b_e, w_e, kv_e, hd_e = cspec = spec_of(k_cache)
    qspec = spec(b_e, None, kv_e, hd_e)
    fn = functools.partial(_decode_attention, pos=pos, window=window, w=w,
                           d=d, mesh=mesh, ring_axis=w_e, hd_axis=hd_e)
    return local_call(fn, (qspec, cspec, cspec), qspec, q, k_cache,
                      v_cache)


def _decode_attention(q, k_cache, v_cache, pos, window, w, d, mesh=None,
                      ring_axis=None, hd_axis=None):
    """:func:`decode_attention` on the slots ``k_cache`` holds of a ring
    of ``w`` (those from this rank's offset on ``ring_axis``) and the
    part of a head_dim of ``d`` it holds (split over ``hd_axis``)."""
    lo = axis_index(mesh, ring_axis) * k_cache.shape[1] if ring_axis else 0
    slots = lo + torch.arange(k_cache.shape[1], device=q.device)
    slot_pos = pos - torch.remainder(pos - slots, w)
    valid = slot_pos >= 0
    if window is not None:
        valid &= slot_pos > pos - window
    reduce = functools.partial(psum, mesh=mesh, axes=hd_axis) \
        if hd_axis else None
    scores = _gqa_scores(q, k_cache, d, reduce).float()     # (B,KV,G,1,W)
    scores = torch.where(valid, scores, NEG_INF)
    if ring_axis:
        mx = pmax(scores.amax(-1, keepdim=True), mesh, ring_axis)
        e = torch.exp(scores - mx)
        probs = e / psum(e.sum(-1, keepdim=True), mesh, ring_axis)
    else:
        probs = torch.softmax(scores, dim=-1)
    out = _gqa_combine(probs.to(q.dtype), v_cache)          # (B,1,H,D)
    return psum(out, mesh, ring_axis) if ring_axis else out


def cache_update(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor, pos: int):
    """Write one token's k/v (B,1,KV,D) into ring slot pos % W of each
    cache, in place; returns the caches. On DTensor caches each rank
    writes its shard, and only the rank whose ring slice holds the slot
    writes at all."""
    slot = pos % k_cache.shape[1]
    mesh = _active_mesh()
    if mesh is None or not isinstance(k_cache, DTensor):
        return _cache_write(k_cache, v_cache, k_new, v_new, slot)
    b_e, w_e, kv_e, hd_e = cspec = spec_of(k_cache)
    nspec = spec(b_e, None, kv_e, hd_e)
    fn = functools.partial(_cache_write, slot=slot, mesh=mesh,
                           ring_axis=w_e)
    return local_call(fn, (cspec, cspec, nspec, nspec), [cspec, cspec],
                      k_cache, v_cache, k_new, v_new)


def _cache_write(kc, vc, kn, vn, slot, mesh=None, ring_axis=None):
    """Ring slot ``slot`` written, where ``kc`` holds it (the slots from
    this rank's offset on ``ring_axis``)."""
    at = slot - (axis_index(mesh, ring_axis) * kc.shape[1]
                 if ring_axis else 0)
    if 0 <= at < kc.shape[1]:
        kc[:, at:at + 1] = kn
        vc[:, at:at + 1] = vn
    return kc, vc


# ---------------------------------------------------------------------------
# attention block (projections + norms + rope)
# ---------------------------------------------------------------------------

def project_q(p: dict, x: torch.Tensor, cfg, positions,
              use_rope: bool = True) -> torch.Tensor:
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.hd
    q = reshape(mm(x, p["wq"]), b, s, h, hd)
    if cfg.qkv_bias:
        q = q + p["bq"].reshape(1, 1, h, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
    return q


def project_kv(p: dict, x: torch.Tensor, cfg, positions,
               use_rope: bool = True) -> tuple:
    b, s, _ = x.shape
    kv, hd = cfg.num_kv_heads, cfg.hd
    k = reshape(mm(x, p["wk"]), b, s, kv, hd)
    v = reshape(mm(x, p["wv"]), b, s, kv, hd)
    if cfg.qkv_bias:
        k = k + p["bk"].reshape(1, 1, kv, hd)
        v = v + p["bv"].reshape(1, 1, kv, hd)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
        k = rope(k, positions, cfg.rope_theta)
    return k, v


def attn_project_qkv(p: dict, x: torch.Tensor, cfg, positions) -> tuple:
    """x: (B,S,d) -> roped q (B,S,H,hd), k,v (B,S,KV,hd)."""
    q = project_q(p, x, cfg, positions)
    k, v = project_kv(p, x, cfg, positions)
    return q, k, v


def attn_block(p: dict, x: torch.Tensor, cfg, *, positions,
               window: Optional[int] = None, causal: bool = True,
               context: Optional[torch.Tensor] = None,
               context_positions=None) -> torch.Tensor:
    """Full attention sub-block (pre-norm residual handled by caller).
    ``context`` switches to cross-attention (k/v projected from context,
    no rope)."""
    if context is None:
        q, k, v = attn_project_qkv(p, x, cfg, positions)
    else:
        q = project_q(p, x, cfg, positions, use_rope=False)
        k, v = project_kv(p, context, cfg, context_positions,
                          use_rope=False)
        causal = False
    o = attention(q, k, v, causal=causal, window=window, chunk=cfg.attn_chunk)
    return mm(reshape(o, x.shape[0], x.shape[1], -1), p["wo"])


def mlp_block(p: dict, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    """``swiglu``: gate|up fused on the weight's size-2 middle axis (d, 2,
    ff); ``gelu``: JAX's default tanh approximation (Whisper)."""
    if kind == "swiglu":
        w = p["w_gateup"]
        if is_split(w, 2):
            # the (d, 2, ff) weight is ff-sharded: DTensor cannot merge a
            # shard of the inner dim, so the two halves go one at a time
            return mm(F.silu(mm(x, w[:, 0])) * mm(x, w[:, 1]), p["w_down"])
        gu = reshape(mm(x, reshape(w, w.shape[0], -1)),
                     *x.shape[:-1], *w.shape[1:])
        return (F.silu(gu[..., 0, :]) * gu[..., 1, :]) @ p["w_down"]
    if kind == "gelu":
        return mm(F.gelu(mm(x, p["w_up"]) + p["b_up"], approximate="tanh"),
                  p["w_down"]) + p["b_down"]
    raise ValueError(kind)
