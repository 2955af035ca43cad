"""Pixtral-12B: mistral-nemo decoder consuming Pixtral-ViT patch embeddings
[hf:mistralai/Pixtral-12B-2409].

The ViT vision encoder + projector is a STUB per the harness carve-out:
input_specs() provides precomputed patch embeddings (B, 1024, 5120)."""
from ..models.lm.config import LMConfig

CONFIG = LMConfig(
    name="pixtral-12b", arch_type="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=131072,
    num_image_tokens=1024, rope_theta=1e6, fsdp=True,
    citation="hf:mistralai/Pixtral-12B-2409; 40L d=5120 32H kv=8 ff=14336 "
             "vocab=131072; ViT frontend stubbed (patch embeddings input)",
)
