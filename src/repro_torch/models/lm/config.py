"""Unified architecture config for the assigned-architecture zoo.

One dataclass covers dense GQA decoders, MoE, Mamba2 (SSD), hybrid
(Zamba2-style shared attention), encoder-decoder audio backbones (Whisper)
and VLM decoders (Pixtral). Every named LM config in
``repro_torch.configs`` is an instance of this.

A copy of ``repro.models.lm.config`` (pure Python); the port adds
:func:`torch_dtype`, the one place where ``dtype`` strings become torch
dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                 # 0 for attention-free (pure SSM)
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None          # default d_model // num_heads
    qk_norm: bool = False                   # qwen3
    qkv_bias: bool = False                  # qwen2
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # attention variants
    sliding_window: Optional[int] = None    # set => banded attention
    attn_chunk: int = 1024                  # query-chunked (flash-style) attn

    # MoE
    num_experts: int = 0
    experts_per_tok: int = 0
    moe_d_ff: int = 0                       # per-expert hidden
    router_aux_coef: float = 0.01
    moe_dispatch: str = "allgather"         # "allgather" | "a2a" (§Perf)
    moe_capacity_factor: float = 2.0

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # hybrid (Zamba2): shared attention block applied every k core layers
    hybrid_attn_every: int = 0

    # encoder-decoder (Whisper backbone; conv/mel frontend is a stub)
    encdec: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 1500                 # whisper frame count

    # VLM (Pixtral): patch embeddings prepended (ViT frontend is a stub)
    num_image_tokens: int = 0

    dtype: str = "bfloat16"
    remat: bool = True
    # sharding: shard big replicated weight dims over "data" too (FSDP/ZeRO-3)
    fsdp: bool = False

    citation: str = ""

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def uses_attention(self) -> bool:
        return self.num_heads > 0 and self.arch_type != "ssm"

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6·N·D)."""
        d = self.d_model
        n = 0
        n += self.padded_vocab * d          # embed
        if not self.tie_embeddings:
            n += self.padded_vocab * d      # lm head
        per_layer = 0
        if self.arch_type in ("dense", "moe", "vlm", "audio", "hybrid"):
            hd, h, kv = self.hd, self.num_heads, self.num_kv_heads
            attn = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
            mlp = 3 * d * self.d_ff if self.d_ff else 0
            if self.arch_type == "moe":
                mlp = 3 * d * self.moe_d_ff * self.num_experts + d * self.num_experts
            if self.arch_type == "hybrid":
                # ssm core layers + shared attn block counted once
                ssm = self._ssm_params()
                n += self.num_layers * (ssm + 2 * d)
                n += attn + 3 * d * self.d_ff + 2 * d   # shared block
                n += 2 * d                               # final norm
                return n
            per_layer = attn + mlp + 2 * d
            layers = self.num_layers
            if self.encdec:
                # encoder layers + decoder cross-attn
                enc = attn + 3 * d * self.d_ff + 2 * d
                per_layer += attn + d                   # cross attn + norm
                n += self.num_encoder_layers * enc
            n += layers * per_layer + 2 * d
        elif self.arch_type == "ssm":
            n += self.num_layers * (self._ssm_params() + 2 * d) + 2 * d
        return n

    def _ssm_params(self) -> int:
        d, di, ns = self.d_model, self.ssm_d_inner, self.ssm_state
        h = self.ssm_heads
        in_proj = d * (2 * di + 2 * ns + h)
        conv = (di + 2 * ns) * self.ssm_conv
        out_proj = di * d
        return in_proj + conv + out_proj + 2 * h

    def active_param_count(self) -> int:
        """N_active for MoE MODEL_FLOPS."""
        if self.arch_type != "moe":
            return self.param_count()
        d = self.d_model
        hd, h, kv = self.hd, self.num_heads, self.num_kv_heads
        attn = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
        mlp = 3 * d * self.moe_d_ff * self.experts_per_tok
        n = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        return n + self.num_layers * (attn + mlp + 2 * d)


_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """An ``LMConfig.dtype`` string as a torch dtype."""
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown LM dtype {name!r}; have "
                         f"{sorted(_TORCH_DTYPES)}") from None
