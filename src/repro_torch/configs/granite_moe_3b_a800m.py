"""Granite-3.0 MoE 3B-a800m: 40 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base family]."""
from ..models.lm.config import LMConfig

CONFIG = LMConfig(
    name="granite-moe-3b-a800m", arch_type="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    head_dim=64, d_ff=512, vocab_size=49155,
    num_experts=40, experts_per_tok=8, moe_d_ff=512,
    rope_theta=1e4, tie_embeddings=True,
    citation="hf:ibm-granite/granite-3.0 MoE family; 32L d=1536 24H kv=8 "
             "expert_ff=512 vocab=49155, 40 experts top-8 (assignment "
             "header says 40e; bracket cites the 1b/32e card — we follow "
             "the structured field)",
)
