"""TinyLlama-1.1B [arXiv:2401.02385]: llama2-arch, 22L d=2048 32H (GQA kv=4)
d_ff=5632, vocab 32000."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=5632, vocab_size=32000, rope_theta=10000.0,
    source="arXiv:2401.02385",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
                       d_ff=512, vocab_size=512)
