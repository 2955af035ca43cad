"""Zamba2-7B: Mamba2 backbone with shared attention blocks [arXiv:2411.15242]."""
from ..models.lm.config import LMConfig

CONFIG = LMConfig(
    name="zamba2-7b", arch_type="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    head_dim=112, d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_chunk=256,
    hybrid_attn_every=6,             # shared attn+MLP block every 6 mamba layers
    rope_theta=1e4, fsdp=True,
    citation="arXiv:2411.15242 (Zamba2); 81L d=3584 32H kv=32 ff=14336 "
             "vocab=32000 ssm_state=64",
)
