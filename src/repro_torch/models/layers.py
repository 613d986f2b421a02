"""Shared layers of the models: RMSNorm, LayerNorm, the group norm, RoPE,
the sinusoidal positions and the SwiGLU and GELU MLPs.

Ports of ``repro.models.layers`` with the same numerics: the norms and
RoPE compute in fp32 (the norms with a biased variance) and cast back to
the activation's type; the MLPs' dense layers compute in the activation's
type. The GELU is the tanh form, ``jax.nn.gelu``'s default. The
sinusoidal table follows the JAX package's eager ops in float32, its
powers of 10000 through XLA's ``powf`` (``xla_math.pow_xla``), so that
the angles at a thousand positions are the same floats.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..sharding import act
from ..xla_math import pow_xla
from .module import Dense, _device_of


class RMSNorm(nn.Module):
    """Holds the fp32 ``scale`` ``[d]`` (ones at init)."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device))

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        return rmsnorm(self.scale, x, eps)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * scale
    return y.to(x.dtype)


class LayerNorm(nn.Module):
    """Holds the fp32 ``scale`` (ones) and ``bias`` (zeros) ``[d]``."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        return layernorm(self, x, eps)


def layernorm(params: LayerNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps) * params.scale + params.bias
    return y.to(x.dtype)


def groupnorm(x: torch.Tensor, n_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Per-head group norm of RWKV6's output: no affine."""
    shape = x.shape
    xf = act.split_last(x.float(), n_groups, shape[-1] // n_groups)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return act.reshape(y, shape).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq] (int). Rotates
    the split halves (not interleaved pairs), as the JAX package does."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)               # [hd/2]
    angles = positions.float()[..., None] * freqs               # [..., seq, hd/2]
    cos = torch.cos(angles)[..., None, :]                       # [..., seq, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """``[n, d]`` fp32: sin of ``pos / 10000^(2i/d)`` in the even columns,
    cos in the odd ones."""
    dim = torch.arange(0, d, 2, dtype=torch.float32)[None, :]
    # true divisions of tensors (a CUDA tensor divided by a Python scalar
    # is multiplied by its reciprocal)
    power = pow_xla(10000.0, dim / torch.tensor(float(d))).to(device)
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    angle = pos / power
    pe = torch.zeros((n, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return pe


class SwiGLU(nn.Module):
    """down(silu(gate(x)) * up(x)); fan-in truncated-normal init."""

    def __init__(self, d_model: int, d_ff: int, generator: torch.Generator | None = None):
        super().__init__()
        dev = _device_of(generator)
        self.gate = Dense(d_model, d_ff, bias=False, device=dev)
        self.up = Dense(d_model, d_ff, bias=False, device=dev)
        self.down = Dense(d_ff, d_model, bias=False, device=dev)
        for m in (self.gate, self.up, self.down):
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu(self, x)


def swiglu(mlp: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    return mlp.down(F.silu(mlp.gate(x)) * mlp.up(x))


class GeluMLP(nn.Module):
    """fc2(gelu(fc1(x))), both with a bias (zeros at init); fan-in
    truncated-normal weights."""

    def __init__(self, d_model: int, d_ff: int, generator: torch.Generator | None = None):
        super().__init__()
        dev = _device_of(generator)
        self.fc1 = Dense(d_model, d_ff, device=dev)
        self.fc2 = Dense(d_ff, d_model, device=dev)
        for m in (self.fc1, self.fc2):
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu_mlp(self, x)


def gelu_mlp(mlp: GeluMLP, x: torch.Tensor) -> torch.Tensor:
    return mlp.fc2(F.gelu(mlp.fc1(x), approximate="tanh"))
