"""RWKV6 "Finch" 1.6B [arXiv:2404.05892]: 24L d=2048 attn-free,
data-dependent decay, d_ff=7168, vocab 65536, head size 64."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, d_ff=7168, vocab_size=65536,
    rwkv_head_size=64,
    source="arXiv:2404.05892",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=256, d_ff=512, vocab_size=512,
                       rwkv_head_size=32)
