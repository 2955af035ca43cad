"""Named architecture configs: the assigned LM pool and the paper's own
GNNs, copies of ``repro.configs``.

Each ``<id>.py`` module defines ``CONFIG`` with the exact assigned
hyper-parameters (citation in ``CONFIG.citation``). ``smoke_variant``
produces the reduced config (<=2 layers, d_model <= 512, <=4 experts) used
by the per-arch CPU tests.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Union

from ..models.gnn.models import GNNConfig
from ..models.lm.config import LMConfig

ARCH_IDS = [
    "zamba2-7b", "qwen3-32b", "llama3-8b", "whisper-base", "mamba2-2.7b",
    "granite-moe-3b-a800m", "qwen2-0.5b", "qwen3-moe-235b-a22b",
    "pixtral-12b", "qwen3-8b",
]

GNN_ARCHS = ["graphsage", "gat", "rgcn"]          # the paper's own models


def get_config(arch_id: str) -> Union[LMConfig, GNNConfig]:
    """The ``LMConfig`` of an id of ``ARCH_IDS``, the ``GNNConfig`` of one
    of ``GNN_ARCHS``."""
    if arch_id not in ARCH_IDS and arch_id not in GNN_ARCHS:
        raise ValueError(f"unknown GNN arch {arch_id!r}; have {GNN_ARCHS} "
                         f"(and the LM ids {ARCH_IDS})")
    mod = importlib.import_module(
        f".{arch_id.replace('-', '_').replace('.', '_')}", __package__)
    return mod.CONFIG


def smoke_variant(cfg: LMConfig) -> LMConfig:
    """Reduced same-family config for CPU smoke tests."""
    d = min(cfg.d_model, 256)
    heads = min(cfg.num_heads, 4) if cfg.num_heads else 0
    kv = min(cfg.num_kv_heads, max(1, heads // 2)) if heads else 0
    upd = dict(
        num_layers=2, d_model=d, num_heads=heads, num_kv_heads=kv,
        head_dim=64 if heads else None,
        d_ff=min(cfg.d_ff, 512), vocab_size=min(cfg.vocab_size, 503),
        attn_chunk=16, remat=False, dtype="float32", fsdp=False,
        sliding_window=None,
    )
    if cfg.num_experts:
        upd.update(num_experts=4, experts_per_tok=2,
                   moe_d_ff=min(cfg.moe_d_ff, 64))
    if cfg.ssm_state:
        upd.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=16)
    if cfg.hybrid_attn_every:
        upd.update(num_layers=3, hybrid_attn_every=2)
    if cfg.encdec:
        upd.update(num_encoder_layers=2, encoder_seq=24)
    if cfg.num_image_tokens:
        upd.update(num_image_tokens=8)
    return dataclasses.replace(cfg, **upd)


def all_configs() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}
