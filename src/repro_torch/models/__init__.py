from .cnn import CNN, cnn_loss, init_cnn
from .encdec import EncDec
from .module import Conv3x3, Dense, Embed, dtype_of, param_count
from .transformer import LM

__all__ = ["CNN", "cnn_loss", "Conv3x3", "Dense", "EncDec", "Embed", "LM",
           "dtype_of", "param_count"]
