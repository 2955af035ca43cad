"""Qwen2-0.5B: dense GQA decoder with QKV bias, tied embeddings [arXiv:2407.10671]."""
from ..models.lm.config import LMConfig

CONFIG = LMConfig(
    name="qwen2-0.5b", arch_type="dense",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    head_dim=64, d_ff=4864, vocab_size=151936,
    qkv_bias=True, tie_embeddings=True, rope_theta=1e6,
    citation="arXiv:2407.10671 (Qwen2); 24L d=896 14H kv=2 ff=4864 "
             "vocab=151936, QKV bias",
)
