"""Whisper-base transformer backbone [arXiv:2212.04356].

The mel-spectrogram + conv frontend is a STUB per the harness carve-out:
input_specs() provides precomputed frame embeddings (B, 1500, 512)."""
from ..models.lm.config import LMConfig

CONFIG = LMConfig(
    name="whisper-base", arch_type="audio", encdec=True,
    num_layers=6, num_encoder_layers=6, encoder_seq=1500,
    d_model=512, num_heads=8, num_kv_heads=8, head_dim=64,
    d_ff=2048, vocab_size=51865,
    rope_theta=1e4, remat=False,
    citation="arXiv:2212.04356 (Whisper); base: 6L enc + 6L dec d=512 8H "
             "ff=2048 vocab=51865; conv frontend stubbed",
)
