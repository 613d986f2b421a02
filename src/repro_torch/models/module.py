"""Layers that keep the JAX package's parameter layout.

The port's parameters are named and shaped as the JAX package's nested
dicts are: a dense layer holds ``w`` as ``[in, out]`` and ``b``; a conv
layer holds ``w`` as HWIO ``[kh, kw, in, out]`` and ``b``. PyTorch's own
layouts (``[out, in]``, OIHW) are produced by a permute inside
``forward``. So ``named_parameters()`` maps one to one onto the JAX
package's leaves, weights convert by identity (``repro_torch.convert``)
and the flattened update vector has the same coefficient order.

Initialization draws from an explicit ``torch.Generator``; it does not
reproduce ``jax.random`` (weights shared with the JAX package come
through ``repro_torch.convert``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Module):
    """y = x @ w + b with ``w`` stored ``[in, out]``."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = True):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out))
        self.b = nn.Parameter(torch.zeros(d_out)) if bias else None

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Truncated-normal fan-in init, as ``repro.models.module.dense_init``."""
        with torch.no_grad():
            nn.init.trunc_normal_(self.w, 0.0, 1.0, -2.0, 2.0,
                                  generator=generator)
            self.w.mul_(1.0 / math.sqrt(self.w.shape[0]))
            if self.b is not None:
                self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w
        return y + self.b if self.b is not None else y


class Conv3x3(nn.Module):
    """3x3 stride-1 "SAME" convolution with ``w`` stored HWIO; takes and
    returns NCHW activations."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(3, 3, c_in, c_out))
        self.b = nn.Parameter(torch.zeros(c_out))

    def reset_parameters(self, generator: torch.Generator | None = None):
        """N(0, 1/fan_in) init, as ``repro.models.cnn.init_cnn``."""
        with torch.no_grad():
            nn.init.normal_(self.w, 0.0, 1.0, generator=generator)
            self.w.mul_(1.0 / math.sqrt(9 * self.w.shape[2]))
            self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.w.permute(3, 2, 0, 1), self.b, padding=1)


def param_count(params: dict) -> int:
    return sum(int(p.numel()) for p in params.values())
