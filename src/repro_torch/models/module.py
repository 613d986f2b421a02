"""Layers that keep the JAX package's parameter layout.

The port's parameters are named and shaped as the JAX package's nested
dicts are: a dense layer holds ``w`` as ``[in, out]`` and ``b``; a conv
layer holds ``w`` as HWIO ``[kh, kw, in, out]`` and ``b``. PyTorch's own
layouts (``[out, in]``, OIHW) are produced by a permute inside
``forward``. So ``named_parameters()`` maps one to one onto the JAX
package's leaves, weights convert by identity (``repro_torch.convert``)
and the flattened update vector has the same coefficient order.

Initialization draws from an explicit ``torch.Generator``, with the JAX
init's distributions; it does not reproduce ``jax.random`` (weights shared
with the JAX package come through ``repro_torch.convert``). Parameters are
allocated on the generator's device.

Dtypes follow the JAX package: parameters are fp32 masters, a dense layer
casts its weight to the activation's type per call (a no-op once the
weights are already in that type, as in a serving copy), the embedding
casts its table before the gather, and ``unembed`` runs in fp32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..sharding import act


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


def _device_of(generator: torch.Generator | None):
    return generator.device if generator is not None else None


class Dense(nn.Module):
    """y = x @ w + b with ``w`` stored ``[in, out]``, computed in x's type."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = True,
                 device=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out, device=device))
        self.b = (nn.Parameter(torch.zeros(d_out, device=device)) if bias
                  else None)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Truncated-normal fan-in init, as ``repro.models.module.dense_init``."""
        with torch.no_grad():
            nn.init.trunc_normal_(self.w, 0.0, 1.0, -2.0, 2.0,
                                  generator=generator)
            self.w.mul_(1.0 / math.sqrt(self.w.shape[0]))
            if self.b is not None:
                self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = act.matmul(x, self.w.to(x.dtype))
        return y + self.b.to(x.dtype) if self.b is not None else y


def trunc_normal_fan_in(shape, fan_in: int, generator: torch.Generator | None = None,
                        device=None, scale: float = 1.0) -> nn.Parameter:
    """A raw weight drawn as ``dense_init``'s: truncated normal on [-2, 2]
    times ``scale / sqrt(fan_in)`` (the expert stacks, RWKV6's decay LoRA)."""
    w = torch.empty(shape, device=device)
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w.mul_(scale / math.sqrt(fan_in))
    return nn.Parameter(w)


class Embed(nn.Module):
    """Token embedding with ``table`` stored ``[vocab, d]``."""

    def __init__(self, vocab: int, d_model: int, generator: torch.Generator | None = None):
        super().__init__()
        self.table = nn.Parameter(torch.empty(vocab, d_model,
                                              device=_device_of(generator)))
        with torch.no_grad():
            self.table.normal_(0.0, 1.0, generator=generator).mul_(0.02)

    def forward(self, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return act.take_rows(self.table.to(dtype), ids)


def token_nll(logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-logp[..., label] of each position: ``logp`` [..., V], ``labels``
    [...] in [0, V). ``nll_loss`` without reduction picks the same values
    as a gather; its backward has a sharded strategy in DTensor, where a
    gather's builds the global gradient on every rank (``launch.dryrun``)."""
    n = labels.numel()
    flat = F.nll_loss(act.reshape(logp, (n, logp.shape[-1])),
                      act.reshape(labels, (n,)).long(), reduction="none")
    return act.reshape(flat, labels.shape)


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Vocab logits in fp32 (for a stable softmax): x @ table^T."""
    return act.matmul(x.float(), table.float().T)


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
