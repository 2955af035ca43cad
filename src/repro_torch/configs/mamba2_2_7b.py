"""Mamba2-2.7B: pure SSD state-space model, attention-free [arXiv:2405.21060]."""
from ..models.lm.config import LMConfig

CONFIG = LMConfig(
    name="mamba2-2.7b", arch_type="ssm",
    num_layers=64, d_model=2560, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_chunk=256,
    tie_embeddings=True, fsdp=True,
    citation="arXiv:2405.21060 (Mamba2/SSD); 64L d=2560 attn-free "
             "vocab=50280 ssm_state=128",
)
