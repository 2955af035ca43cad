"""Qwen3-32B: dense GQA decoder with per-head q/k RMSNorm [hf:Qwen/Qwen3-8B family]."""
from ..models.lm.config import LMConfig

CONFIG = LMConfig(
    name="qwen3-32b", arch_type="dense",
    num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=25600, vocab_size=151936,
    qk_norm=True, rope_theta=1e6, fsdp=True,
    citation="hf:Qwen/Qwen3-8B family card; 64L d=5120 64H kv=8 ff=25600 "
             "vocab=151936, qk_norm",
)
