"""Update compression: per-client block top-k sparsification.

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

__all__ = ["DEFAULT_BLOCK", "batch_block_topk"]


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
