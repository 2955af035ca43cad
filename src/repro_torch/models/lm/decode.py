"""Serving path: cache init, prefill, and single-token decode for every
architecture family; the port of ``repro.models.lm.decode``.

Caches are ring buffers of length ``cache_len`` (== sliding window for
windowed configs, == max_seq for full attention), in the reference's
layout: one tensor per entry with a leading layer axis, and ``pos`` (a
Python int here) the position of the next token. SSM/hybrid archs carry
O(1) recurrent state instead of (or in addition to) KV rings.

:func:`decode_step` updates the cache it is given in place (a server keeps
one cache per batch and never reads an old one) and returns it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor

from ...sharding.rules import (_active_mesh, cache_pspecs, current_rules,
                               local_call, mm, placements, reshape, spec,
                               spec_of)
from .config import LMConfig, torch_dtype
from .layers import (attention, cache_update, decode_attention, mlp_block,
                     project_kv, project_q, rmsnorm)
from .model import embed_tokens, layer, lm_head, num_stacked
from .moe import moe_block
from .ssm import mamba2_block


# ---------------------------------------------------------------------------
# cache init
# ---------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, cache_len: int,
               encoder_seq: Optional[int] = None, device="cpu",
               mesh=None) -> dict:
    """Zeroed caches; with ``mesh``, DTensors placed by ``cache_pspecs``
    under the current rules (each rank allocates its shards only)."""
    dtype = torch_dtype(cfg.dtype)
    kv, hd = cfg.num_kv_heads, cfg.hd
    at = cfg.arch_type

    def zeros(*shape, dt=dtype):
        return _Zeros(shape, dt)

    cache: dict = {"pos": 0}
    if at in ("dense", "moe", "vlm"):
        cache["k"] = zeros(cfg.num_layers, batch, cache_len, kv, hd)
        cache["v"] = zeros(cfg.num_layers, batch, cache_len, kv, hd)
    elif at == "ssm":
        cache["ssm"] = zeros(cfg.num_layers, batch, cfg.ssm_heads,
                             cfg.ssm_head_dim, cfg.ssm_state,
                             dt=torch.float32)
        cache["conv"] = zeros(cfg.num_layers, batch, cfg.ssm_conv - 1,
                              cfg.ssm_d_inner + 2 * cfg.ssm_state)
    elif at == "hybrid":
        ke = cfg.hybrid_attn_every
        ns = cfg.num_layers // ke
        nt = cfg.num_layers - ns * ke
        conv_c = cfg.ssm_d_inner + 2 * cfg.ssm_state
        state = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
        cache["ssm"] = zeros(ns, ke, batch, *state, dt=torch.float32)
        cache["conv"] = zeros(ns, ke, batch, cfg.ssm_conv - 1, conv_c)
        cache["k"] = zeros(ns, batch, cache_len, kv, hd)
        cache["v"] = zeros(ns, batch, cache_len, kv, hd)
        if nt:
            cache["tail_ssm"] = zeros(nt, batch, *state, dt=torch.float32)
            cache["tail_conv"] = zeros(nt, batch, cfg.ssm_conv - 1, conv_c)
    elif at == "audio":
        enc_s = encoder_seq or cfg.encoder_seq
        cache["k"] = zeros(cfg.num_layers, batch, cache_len, kv, hd)
        cache["v"] = zeros(cfg.num_layers, batch, cache_len, kv, hd)
        cache["xk"] = zeros(cfg.num_layers, batch, enc_s, kv, hd)
        cache["xv"] = zeros(cfg.num_layers, batch, enc_s, kv, hd)
    else:
        raise ValueError(at)
    if mesh is None:
        return {k: v.make(device) if isinstance(v, _Zeros) else v
                for k, v in cache.items()}
    specs = cache_pspecs(cfg, cache, batch, current_rules())
    return {k: v.make_sharded(mesh, specs[k]) if isinstance(v, _Zeros)
            else v for k, v in cache.items()}


class _Zeros:
    """A cache entry's shape and dtype, made at the end of ``init_cache``
    (after its specs are known, for a sharded cache)."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = tuple(shape), dtype

    def make(self, device):
        return torch.zeros(self.shape, dtype=self.dtype, device=device)

    def make_sharded(self, mesh, spec_):
        from torch.distributed.tensor import zeros
        return zeros(self.shape, dtype=self.dtype, device_mesh=mesh,
                     placements=placements(spec_, mesh))


def _lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; a DTensor table by :func:`embed_tokens`."""
    if isinstance(table, DTensor):
        return embed_tokens(table, tokens)
    return table[tokens]


def _ring_fill(k_seq: torch.Tensor, cache_len: int) -> torch.Tensor:
    """(B, S, KV, hd) per-position k/v -> ring cache (B, W, KV, hd). On a
    DTensor, on each rank's batch and heads (the ring whole)."""
    if _active_mesh() is not None and isinstance(k_seq, DTensor):
        b_e, _, kv_e, hd_e = spec_of(k_seq)
        sp = spec(b_e, None, kv_e, hd_e)
        return local_call(lambda t: _ring_fill(t, cache_len), (sp,), sp,
                          k_seq)
    s = k_seq.shape[1]
    w = cache_len
    if s <= w:
        return F.pad(k_seq, (0, 0, 0, 0, 0, w - s))
    # keep the last w positions, each in slot pos % w
    slots = torch.arange(s - w, s, device=k_seq.device) % w
    out = k_seq.new_zeros((k_seq.shape[0], w) + k_seq.shape[2:])
    out[:, slots] = k_seq[:, s - w:]
    return out


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def _attn_prefill(cfg, ap, hn, positions, window, cache_len):
    """Self-attention over the prompt -> (output (B,S,d), ring k, ring v)."""
    b, s, _ = hn.shape
    q = project_q(ap, hn, cfg, positions)
    k, v = project_kv(ap, hn, cfg, positions)
    o = attention(q, k, v, causal=True, window=window, chunk=cfg.attn_chunk)
    return (mm(reshape(o, b, s, -1), ap["wo"]), _ring_fill(k, cache_len),
            _ring_fill(v, cache_len))


def _mamba_prefill(cfg, bp, h):
    out, S, conv = mamba2_block(bp["mamba"],
                                rmsnorm(h, bp["ln1"], cfg.norm_eps), cfg)
    return h + out, S, conv


@torch.no_grad()
def prefill(cfg: LMConfig, params: dict, tokens: torch.Tensor,
            cache_len: int, *, image_embeds=None, encoder_embeds=None,
            window: Optional[int] = None) -> tuple:
    """Run the full prompt, build the serve cache.
    Returns (last-position logits (B, padded_vocab), cache).

    ``window`` overrides the config's sliding window for this call; the
    ring keeps the last ``cache_len`` positions whatever the window."""
    window = window if window is not None else cfg.sliding_window
    x = _lookup(params["embed"], tokens)
    if cfg.arch_type == "vlm":
        x = torch.cat([image_embeds.to(x.dtype), x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    at = cfg.arch_type
    mesh = _active_mesh()
    cache = init_cache(cfg, b, cache_len,
                       encoder_seq=None if encoder_embeds is None
                       else encoder_embeds.shape[1], device=x.device,
                       mesh=mesh if isinstance(x, DTensor) else None)
    blocks = params["blocks"]

    if at in ("dense", "moe", "vlm"):
        for i in range(num_stacked(blocks)):
            bp = layer(blocks, i)
            o, cache["k"][i], cache["v"][i] = _attn_prefill(
                cfg, bp["attn"], rmsnorm(x, bp["ln1"], cfg.norm_eps),
                positions, window, cache_len)
            x = x + o
            hn = rmsnorm(x, bp["ln2"], cfg.norm_eps)
            if "moe" in bp:
                ff, _ = moe_block(bp["moe"], hn, cfg)
            else:
                ff = mlp_block(bp["mlp"], hn)
            x = x + ff

    elif at == "ssm":
        for i in range(num_stacked(blocks)):
            x, cache["ssm"][i], cache["conv"][i] = _mamba_prefill(
                cfg, layer(blocks, i), x)

    elif at == "hybrid":
        shared = params["shared"]
        for i in range(num_stacked(blocks)):
            sbp = layer(blocks, i)
            for j in range(num_stacked(sbp)):
                x, cache["ssm"][i, j], cache["conv"][i, j] = _mamba_prefill(
                    cfg, layer(sbp, j), x)
            o, cache["k"][i], cache["v"][i] = _attn_prefill(
                cfg, shared["attn"], rmsnorm(x, shared["ln_a"], cfg.norm_eps),
                positions, window, cache_len)
            x = x + o
            x = x + mlp_block(shared["mlp"],
                              rmsnorm(x, shared["ln_m"], cfg.norm_eps))
        tail = params.get("tail_blocks")
        for i in range(num_stacked(tail) if tail is not None else 0):
            x, cache["tail_ssm"][i], cache["tail_conv"][i] = _mamba_prefill(
                cfg, layer(tail, i), x)

    elif at == "audio":
        enc = encoder_embeds.to(x.dtype)
        enc_pos = torch.arange(enc.shape[1], device=x.device)
        eb = params["enc_blocks"]
        for i in range(num_stacked(eb)):
            bp = layer(eb, i)
            hn = rmsnorm(enc, bp["ln1"], cfg.norm_eps)
            q = project_q(bp["attn"], hn, cfg, enc_pos)
            k, v = project_kv(bp["attn"], hn, cfg, enc_pos)
            o = attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
            enc = enc + mm(reshape(o, enc.shape[0], enc.shape[1], -1),
                           bp["attn"]["wo"])
            enc = enc + mlp_block(bp["mlp"],
                                  rmsnorm(enc, bp["ln2"], cfg.norm_eps),
                                  kind="gelu")
        enc = rmsnorm(enc, params["enc_norm"], cfg.norm_eps)
        for i in range(num_stacked(blocks)):
            bp = layer(blocks, i)
            o, cache["k"][i], cache["v"][i] = _attn_prefill(
                cfg, bp["attn"], rmsnorm(x, bp["ln1"], cfg.norm_eps),
                positions, window, cache_len)
            x = x + o
            hx = rmsnorm(x, bp["ln_x"], cfg.norm_eps)
            qx = project_q(bp["xattn"], hx, cfg, positions, use_rope=False)
            xk, xv = project_kv(bp["xattn"], enc, cfg, enc_pos,
                                use_rope=False)
            cache["xk"][i], cache["xv"][i] = xk, xv
            ox = attention(qx, xk, xv, causal=False, chunk=cfg.attn_chunk)
            x = x + mm(reshape(ox, b, s, -1), bp["xattn"]["wo"])
            x = x + mlp_block(bp["mlp"], rmsnorm(x, bp["ln2"], cfg.norm_eps),
                              kind="gelu")
    else:
        raise ValueError(at)

    cache["pos"] = s
    x = rmsnorm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return mm(x, lm_head(cfg, params))[:, 0], cache


# ---------------------------------------------------------------------------
# decode (one token)
# ---------------------------------------------------------------------------

@torch.no_grad()
def decode_step(cfg: LMConfig, params: dict, cache: dict,
                tokens: torch.Tensor, *, window: Optional[int] = None
                ) -> tuple:
    """tokens: (B, 1) the token generated at position cache['pos'].
    Returns (logits (B, padded_vocab) for the next position, the cache,
    updated in place). ``window`` overrides the config's sliding window
    for this step."""
    window = window if window is not None else cfg.sliding_window
    pos = cache["pos"]
    x = _lookup(params["embed"], tokens)            # (B, 1, d)
    b = x.shape[0]
    positions = torch.full((1,), pos, device=x.device)
    at = cfg.arch_type
    blocks = params["blocks"]

    def attn_decode(ap, hn, kc, vc):
        q = project_q(ap, hn, cfg, positions)
        k, v = project_kv(ap, hn, cfg, positions)
        kc, vc = cache_update(kc, vc, k, v, pos)
        o = decode_attention(q, kc, vc, pos, window=window)
        return mm(reshape(o, b, 1, -1), ap["wo"])

    def mamba_decode(bp, h, S, conv):
        """One Mamba2 layer; writes its new states into S and conv."""
        out, S_new, conv_new = mamba2_block(
            bp["mamba"], rmsnorm(h, bp["ln1"], cfg.norm_eps), cfg,
            ssm_state=S, conv_state=conv, decode=True)
        S.copy_(S_new)
        conv.copy_(conv_new)
        return h + out

    if at in ("dense", "moe", "vlm"):
        for i in range(num_stacked(blocks)):
            bp = layer(blocks, i)
            x = x + attn_decode(bp["attn"],
                                rmsnorm(x, bp["ln1"], cfg.norm_eps),
                                cache["k"][i], cache["v"][i])
            hn = rmsnorm(x, bp["ln2"], cfg.norm_eps)
            if "moe" in bp:
                ff, _ = moe_block(bp["moe"], hn, cfg)
            else:
                ff = mlp_block(bp["mlp"], hn)
            x = x + ff

    elif at == "ssm":
        for i in range(num_stacked(blocks)):
            x = mamba_decode(layer(blocks, i), x, cache["ssm"][i],
                             cache["conv"][i])

    elif at == "hybrid":
        shared = params["shared"]
        for i in range(num_stacked(blocks)):
            sbp = layer(blocks, i)
            for j in range(num_stacked(sbp)):
                x = mamba_decode(layer(sbp, j), x, cache["ssm"][i, j],
                                 cache["conv"][i, j])
            x = x + attn_decode(shared["attn"],
                                rmsnorm(x, shared["ln_a"], cfg.norm_eps),
                                cache["k"][i], cache["v"][i])
            x = x + mlp_block(shared["mlp"],
                              rmsnorm(x, shared["ln_m"], cfg.norm_eps))
        tail = params.get("tail_blocks")
        for i in range(num_stacked(tail) if tail is not None else 0):
            x = mamba_decode(layer(tail, i), x, cache["tail_ssm"][i],
                             cache["tail_conv"][i])

    elif at == "audio":
        for i in range(num_stacked(blocks)):
            bp = layer(blocks, i)
            x = x + attn_decode(bp["attn"],
                                rmsnorm(x, bp["ln1"], cfg.norm_eps),
                                cache["k"][i], cache["v"][i])
            hx = rmsnorm(x, bp["ln_x"], cfg.norm_eps)
            qx = project_q(bp["xattn"], hx, cfg, positions, use_rope=False)
            sc = attention(qx, cache["xk"][i], cache["xv"][i], causal=False,
                           chunk=1)
            x = x + mm(reshape(sc, b, 1, -1), bp["xattn"]["wo"])
            x = x + mlp_block(bp["mlp"], rmsnorm(x, bp["ln2"], cfg.norm_eps),
                              kind="gelu")
    else:
        raise ValueError(at)

    cache["pos"] = pos + 1
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return mm(x, lm_head(cfg, params))[:, 0], cache
