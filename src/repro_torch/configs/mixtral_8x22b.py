"""Mixtral-8x22B [arXiv:2401.04088]: 56L d=6144 48H (GQA kv=8) expert
d_ff=16384, vocab 32768, 8 experts top-2, sliding-window attention."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, moe_d_ff=16384, vocab_size=32768,
    n_experts=8, n_experts_per_tok=2, sliding_window=4096,
    rope_theta=1e6,
    source="arXiv:2401.04088",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
                       d_ff=512, moe_d_ff=512, vocab_size=512,
                       n_experts=4, n_experts_per_tok=2, sliding_window=64)
