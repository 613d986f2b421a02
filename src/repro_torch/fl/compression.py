"""Update compression: block top-k sparsification (per client, or of one
vector), exact global top-k, and the symmetric fixed-point quantizers.

``batch_block_topk`` keeps, in every ``block``-wide block of client i's
flat update (``DEFAULT_BLOCK`` = 4096 by default), the ``k_i = ceil(
gamma_i * block)`` largest magnitudes (ties to the lower index) — the
JAX package's keep rule, so the payload is exactly gamma per block and
the energy model's gamma*S charge holds. The
work is one call of ``kernels.topk_sparsify.ops.block_topk_rows``: the CUDA
kernel on the card, its plain version on the CPU. ``block_topk`` does the
same with one static gamma for a 1-D vector, at a block width of its own
(the cross-silo aggregation of ``fl.collectives``), through
``kernels.topk_sparsify.ops.block_topk_sparsify``.

``global_topk``, ``quantize_int8`` and ``dequantize_int8`` are plain
PyTorch, as the JAX package computes them with plain XLA ops.
"""
from __future__ import annotations

import math

import torch

from ..kernels.topk_sparsify.ops import block_topk_rows, block_topk_sparsify
from ..kernels.topk_sparsify.ref import DEFAULT_BLOCK
from ..xla_math import exp2_xla

__all__ = ["DEFAULT_BLOCK", "batch_block_topk", "block_topk",
           "dequantize_int8", "effective_gamma", "global_topk",
           "quantize_int8", "quantize_rows"]


def global_topk(vec: torch.Tensor, gamma) -> tuple[torch.Tensor, int]:
    """Exact top-``k`` magnitudes of the whole vector, ``k = clip(ceil(
    gamma * n), 1, n)``; ties at the k-th magnitude go to the lower index.
    Dropped lanes are ``vec * 0`` (the reference multiplies eagerly: a
    dropped NaN stays NaN, a negative lane becomes -0.0)."""
    n = vec.shape[0]
    k = min(n, max(1, int(math.ceil(float(gamma) * n))))
    mag = torch.abs(vec)
    thresh = torch.topk(mag, k).values[-1]
    mask = mag >= thresh
    mask = mask & (torch.cumsum(mask.to(torch.int32), dim=0) <= k)
    return vec * mask.to(vec.dtype), k


def block_topk(vec: torch.Tensor, gamma, block: int = DEFAULT_BLOCK
               ) -> tuple[torch.Tensor, int]:
    """Keep the top ``ceil(gamma * block)`` magnitudes inside each block of
    a 1-D vector (the B-7 kernel on the card)."""
    return block_topk_sparsify(vec, gamma, block=block)


def batch_block_topk(mat: torch.Tensor, gamma: torch.Tensor,
                     block: int = DEFAULT_BLOCK,
                     skip_full: bool = True) -> torch.Tensor:
    """mat: [N, D] stacked flat updates; gamma: [N] fp32 keep ratios.
    D is cut into whole ``block``-wide blocks, the ragged tail padded with
    zeros that compete like any value and are dropped again; client i keeps
    ``clip(ceil(gamma_i * block), 1, block)`` lanes a block. With
    ``skip_full``, when every client has gamma = 1 the matrix passes
    through unchanged (the reference's all-full skip); otherwise a gamma =
    1 row loses only its NaN lanes, as under the reference's mask."""
    ks = torch.clamp(torch.ceil(gamma * block).to(torch.int32), 1, block)
    return block_topk_rows(mat, ks, block=block, skip_full=skip_full)


def quantize_rows(rows: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Simulated symmetric quantize->dequantize of each row of ``rows``
    [N, D] at its width ``bits`` [N] (float32).

    Non-finite lanes are zeroed first (a quantized payload cannot carry
    NaN/Inf) — also on rows with bits >= 32, which then pass through
    otherwise untouched (float32 is the uncompressed wire format). The
    scale is ``max|row| / qmax`` with ``qmax = 2**(bits-1) - 1`` (at least
    1) built on XLA's exp2, as in the reference; ``torch.round`` rounds
    half to even like ``jnp.round``, so the output is the reference's bit
    for bit, signed zeros included. Plain PyTorch: the reference computes
    it with plain XLA ops, not a kernel."""
    finite = torch.isfinite(rows)
    clean = torch.where(finite, rows, 0.0)
    qmax = torch.clamp(exp2_xla(bits - 1.0) - 1.0, min=1.0)[:, None]  # [N,1]
    scale = torch.clamp(torch.amax(torch.abs(clean), dim=1, keepdim=True),
                        min=1e-12) / qmax
    deq = torch.minimum(torch.maximum(torch.round(clean / scale), -qmax),
                        qmax) * scale
    return torch.where(bits[:, None] >= 32.0, clean, deq)


def quantize_int8(vec: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: (q, scale) with ``scale = max|vec| / 127``
    (at least 1e-12 / 127) after non-finite lanes are zeroed, ``q =
    clip(round(vec / scale), -127, 127)``, rounding half to even."""
    vec = torch.where(torch.isfinite(vec), vec, 0.0)
    scale = torch.clamp(torch.amax(torch.abs(vec)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(vec / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def effective_gamma(gamma, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """The keep fraction the block scheme realizes:
    ``clip(ceil(gamma*block), 1, block) / block`` — the same k rule as
    ``batch_block_topk``."""
    return torch.clamp(torch.ceil(torch.as_tensor(gamma) * block),
                       1, block) / block
