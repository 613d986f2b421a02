from .base import ChannelConfig, FairEnergyConfig, FLConfig, ModelConfig

__all__ = ["ChannelConfig", "FairEnergyConfig", "FLConfig", "ModelConfig"]
