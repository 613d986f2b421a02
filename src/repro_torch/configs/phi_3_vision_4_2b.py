"""Phi-3-vision-4.2B [hf:microsoft/Phi-3-vision-128k-instruct]: phi3-mini
backbone 32L d=3072 32H (kv=32) d_ff=8192 vocab 32064 + CLIP vision tower
(STUB: precomputed patch embeddings, 576 tokens)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32064, n_vision_tokens=576,
    rope_theta=10000.0,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
                       d_ff=512, vocab_size=512, n_vision_tokens=16)
