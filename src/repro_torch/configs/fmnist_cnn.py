"""The paper's own model: ~2M-param CNN on (non-IID) FMNIST (Sec. VII)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="fmnist-cnn", family="cnn",
    n_layers=2, d_model=0,
    cnn_channels=(32, 64), cnn_dense=512,
    input_hw=(28, 28, 1), n_classes=10, dtype="float32",
    source="FairEnergy Sec. VII",
)

SMOKE = CONFIG.replace(cnn_channels=(8, 16), cnn_dense=64)
