"""Whisper-tiny [arXiv:2212.04356]: enc-dec, 4+4L d=384 6H d_ff=1536,
vocab 51865. Conv/mel frontend is a STUB (precomputed frame embeddings)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, n_encoder_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51865, is_encoder_decoder=True,
    n_audio_frames=1500, max_target_len=448, tie_embeddings=True,
    source="arXiv:2212.04356",
)

SMOKE = CONFIG.replace(n_layers=2, n_encoder_layers=2, d_model=128,
                       n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=512,
                       n_audio_frames=64, max_target_len=64)
