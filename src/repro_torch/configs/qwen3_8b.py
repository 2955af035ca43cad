"""Qwen3-8B: dense GQA decoder with qk_norm [hf:Qwen/Qwen3-8B]."""
from ..models.lm.config import LMConfig

CONFIG = LMConfig(
    name="qwen3-8b", arch_type="dense",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=12288, vocab_size=151936,
    qk_norm=True, rope_theta=1e6, fsdp=True,
    citation="hf:Qwen/Qwen3-8B; 36L d=4096 32H kv=8 ff=12288 vocab=151936, "
             "qk_norm",
)
