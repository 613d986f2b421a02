"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L d=2048 16H(kv=16)
expert d_ff=1408, vocab 151936, 60 routed experts top-4 + 4 shared."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, moe_d_ff=1408, vocab_size=151936,
    n_experts=60, n_experts_per_tok=4, n_shared_experts=4,
    qkv_bias=True, rope_theta=1e6,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
                       d_ff=128, moe_d_ff=128, vocab_size=512,
                       n_experts=4, n_experts_per_tok=2, n_shared_experts=1)
