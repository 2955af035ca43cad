"""Llama-3-8B: dense GQA decoder, 128k vocab [arXiv:2407.21783]."""
from ..models.lm.config import LMConfig

CONFIG = LMConfig(
    name="llama3-8b", arch_type="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=128256,
    rope_theta=5e5, fsdp=True,
    citation="arXiv:2407.21783 (Llama 3); 32L d=4096 32H kv=8 ff=14336 "
             "vocab=128256",
)
