"""Qwen3-MoE 235B-A22B: 128 experts top-8, GQA kv=4, qk_norm
[hf:Qwen/Qwen3-30B-A3B family]."""
from ..models.lm.config import LMConfig

CONFIG = LMConfig(
    name="qwen3-moe-235b-a22b", arch_type="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    head_dim=128, d_ff=1536, vocab_size=151936,
    num_experts=128, experts_per_tok=8, moe_d_ff=1536,
    qk_norm=True, rope_theta=1e6, fsdp=True,
    citation="hf:Qwen/Qwen3-30B-A3B family card; 94L d=4096 64H kv=4 "
             "expert_ff=1536 vocab=151936, 128 experts top-8, qk_norm",
)
