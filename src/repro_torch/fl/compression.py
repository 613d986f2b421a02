"""Update compression: per-client block top-k sparsification, and the
symmetric fixed-point quantizer of the quantized-payload path.

``batch_block_topk`` keeps, in every ``DEFAULT_BLOCK``-wide block of
client i's flat update, the ``k_i = ceil(gamma_i * DEFAULT_BLOCK)``
largest magnitudes (ties
to the lower index) — the JAX package's keep rule, so the payload is
exactly gamma per block and the energy model's gamma*S charge holds. The
work is one call of ``kernels.topk_sparsify.ops.block_topk_rows``: the CUDA
kernel on the card, its plain version on the CPU.
"""
from __future__ import annotations

import torch

from ..kernels.topk_sparsify.ops import block_topk_rows
from ..kernels.topk_sparsify.ref import DEFAULT_BLOCK
from ..xla_math import exp2_xla

__all__ = ["DEFAULT_BLOCK", "batch_block_topk", "effective_gamma",
           "quantize_rows"]


def batch_block_topk(mat: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """mat: [N, D] stacked flat updates; gamma: [N] fp32 keep ratios.
    D is cut into whole blocks, the ragged tail padded with zeros that
    compete like any value and are dropped again. When every client has
    gamma = 1 the matrix passes through unchanged (the reference's
    all-full skip); otherwise a gamma = 1 row loses only its NaN lanes,
    as under the reference's mask."""
    ks = torch.clamp(torch.ceil(gamma * DEFAULT_BLOCK).to(torch.int32), 1,
                     DEFAULT_BLOCK)
    return block_topk_rows(mat, ks)


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


def effective_gamma(gamma) -> torch.Tensor:
    """The keep fraction the block scheme realizes:
    ``clip(ceil(gamma*DEFAULT_BLOCK), 1, DEFAULT_BLOCK) / DEFAULT_BLOCK``
    — the same k rule as ``batch_block_topk``."""
    return torch.clamp(torch.ceil(torch.as_tensor(gamma) * DEFAULT_BLOCK),
                       1, DEFAULT_BLOCK) / DEFAULT_BLOCK
