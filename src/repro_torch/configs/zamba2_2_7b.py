"""Zamba2-2.7B [arXiv:2411.15242]: 54 Mamba2 layers d=2560 (state 64) with a
SHARED attention+MLP block (32H kv=32, d_ff=10240) applied every 6 layers."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
    attn_every=6, head_dim=80,
    source="arXiv:2411.15242",
)

SMOKE = CONFIG.replace(n_layers=4, d_model=256, n_heads=4, n_kv_heads=4,
                       d_ff=512, vocab_size=512, attn_every=2, head_dim=64,
                       ssm_head_dim=32)
