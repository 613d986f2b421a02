from .cnn import CNN, cnn_loss
from .module import Conv3x3, Dense, param_count

__all__ = ["CNN", "cnn_loss", "Conv3x3", "Dense", "param_count"]
