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

import math
from typing import Optional

import torch
import torch.nn.functional as F

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


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,Sq,H,D), k: (B,Sk,KV,D) -> (B,KV,G,Sq,Sk), G = H // KV."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, d)
    return (torch.einsum("bqkgd,bskd->bkgqs", qg, k)
            / _in_dtype(math.sqrt(d), q.dtype))


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
    exceeds (B, H, chunk, Sk)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    g = h // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
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
    the > pos tail."""
    w = k_cache.shape[1]
    slots = torch.arange(w, device=q.device)
    slot_pos = pos - torch.remainder(pos - slots, w)
    valid = slot_pos >= 0
    if window is not None:
        valid &= slot_pos > pos - window
    scores = _gqa_scores(q, k_cache).float()                # (B,KV,G,1,W)
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _gqa_combine(probs, v_cache)                     # (B,1,H,D)


def cache_update(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor, pos: int):
    """Write one token's k/v (B,1,KV,D) into ring slot pos % W of each
    cache, in place; returns the caches."""
    slot = pos % k_cache.shape[1]
    k_cache[:, slot:slot + 1] = k_new
    v_cache[:, slot:slot + 1] = v_new
    return k_cache, v_cache


# ---------------------------------------------------------------------------
# attention block (projections + norms + rope)
# ---------------------------------------------------------------------------

def project_q(p: dict, x: torch.Tensor, cfg, positions,
              use_rope: bool = True) -> torch.Tensor:
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.hd
    q = (x @ p["wq"]).reshape(b, s, h, hd)
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
    k = (x @ p["wk"]).reshape(b, s, kv, hd)
    v = (x @ p["wv"]).reshape(b, s, kv, hd)
    if cfg.qkv_bias:
        k = k + p["bk"].reshape(1, 1, kv, hd)
        v = v + p["bv"].reshape(1, 1, kv, hd)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
        k = rope(k, positions, cfg.rope_theta)
    return k, v


def attn_block(p: dict, x: torch.Tensor, cfg, *, positions,
               window: Optional[int] = None, causal: bool = True,
               context: Optional[torch.Tensor] = None,
               context_positions=None) -> torch.Tensor:
    """Full attention sub-block (pre-norm residual handled by caller).
    ``context`` switches to cross-attention (k/v projected from context,
    no rope)."""
    if context is None:
        q = project_q(p, x, cfg, positions)
        k, v = project_kv(p, x, cfg, positions)
    else:
        q = project_q(p, x, cfg, positions, use_rope=False)
        k, v = project_kv(p, context, cfg, context_positions,
                          use_rope=False)
        causal = False
    o = attention(q, k, v, causal=causal, window=window, chunk=cfg.attn_chunk)
    return o.reshape(x.shape[0], x.shape[1], -1) @ p["wo"]


def mlp_block(p: dict, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    """``swiglu``: gate|up fused on the weight's size-2 middle axis (d, 2,
    ff); ``gelu``: JAX's default tanh approximation (Whisper)."""
    if kind == "swiglu":
        w = p["w_gateup"]
        gu = (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])
        return (F.silu(gu[..., 0, :]) * gu[..., 1, :]) @ p["w_down"]
    if kind == "gelu":
        return (F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
                @ p["w_down"] + p["b_down"])
    raise ValueError(kind)
