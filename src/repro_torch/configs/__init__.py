"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke(arch_id)``.

The JAX package's registry, over the port's copies of its config modules
(data only; each cites its source in ``ModelConfig.source``).
"""
from __future__ import annotations

import importlib

from .base import (SHAPES, ChannelConfig, FairEnergyConfig, FLConfig,
                   ModelConfig, ShapeConfig)

ARCH_IDS = [
    "qwen2-moe-a2.7b",
    "tinyllama-1.1b",
    "whisper-tiny",
    "rwkv6-1.6b",
    "zamba2-2.7b",
    "mixtral-8x22b",
    "qwen2.5-32b",
    "phi-3-vision-4.2b",
    "glm4-9b",
    "qwen2-72b",
]

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCH_IDS}
_MODULES["fmnist-cnn"] = "repro_torch.configs.fmnist_cnn"


def get_config(arch_id: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def get_smoke(arch_id: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch_id]).SMOKE


__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "ShapeConfig", "ChannelConfig",
           "FairEnergyConfig", "FLConfig", "get_config", "get_smoke"]
