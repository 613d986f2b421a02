"""Float32 functions computed the way XLA lowers them, where the port has
to be bit-equal to the JAX package.

XLA evaluates ``exp2(x)`` as ``exp(x * ln2)`` in float32, which is not an
exact power of two: ``exp2(15)`` is 32767.984, not 32768. The quantizer's
``qmax = 2**(bits-1) - 1`` and the score fidelity ``1 - 2**(1-bits)`` are
built on it in the reference, so the port builds them the same way.
"""
from __future__ import annotations

import numpy as np
import torch

LN2_F32 = float(np.float32(np.log(2.0)))


def exp2_xla(x: torch.Tensor) -> torch.Tensor:
    """``exp(x * float32(ln 2))``: XLA's float32 ``exp2``. On the CPU it
    equals the reference bit for bit at every integer in [-40, 31]."""
    return torch.exp(x * LN2_F32)
