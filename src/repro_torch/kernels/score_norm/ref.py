"""Plain PyTorch version of the blockwise sum-of-squares row norms.

The contribution score's input is ||u_i||_2 for every client's flat update
row. As in the JAX package's ``score_norm`` kernel, each row is cut into
``block``-wide blocks (the tail zero-padded), each block's fp32 sum of
squares is a partial, and the norm is sqrt(sum of the partials).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def sq_sum_partials_ref(mat: Tensor, block: int) -> Tensor:
    """[N, D] -> [N, ceil(D / block)] fp32 partial sums of squares."""
    n, d = mat.shape
    nb = -(-d // block)
    x = F.pad(mat.to(torch.float32), (0, nb * block - d)).reshape(n, nb, block)
    return torch.sum(x * x, dim=-1)


def norms_from_partials(partials: Tensor) -> Tensor:
    """[N, nb] fp32 partials -> [N] norms: sqrt of each row's sum, the sum
    accumulated in float64 and rounded once to fp32, so that a row's norm
    does not depend on how many rows the reduction holds (the library
    reduces rows of a small matrix in orders that follow its shape;
    ROADMAP C-17)."""
    return torch.sqrt(torch.sum(partials, dim=1, dtype=torch.float64)
                      .to(torch.float32))


def row_l2_norms_ref(mat: Tensor, block: int) -> Tensor:
    """[N, D] -> [N] row L2 norms."""
    return norms_from_partials(sq_sum_partials_ref(mat, block))


def l2_norm_blocks(vec: Tensor, block: int = 65536) -> Tensor:
    """||vec||_2 by the JAX package's ``l2_norm`` rule: blocks of
    ``min(block, max(128, next power of two >= n))`` lanes, the tail zero
    padded, one fp32 partial a block, the root of their sum (in float64,
    ``norms_from_partials``)."""
    n = vec.shape[0]
    block = min(block, max(128, 1 << (n - 1).bit_length()))
    return norms_from_partials(sq_sum_partials_ref(vec[None], block))[0]


def l2_norm_ref(vec: Tensor) -> Tensor:
    """||vec||_2 in one fp32 sum of squares (the JAX package's oracle)."""
    return torch.sqrt(torch.sum(torch.square(vec.to(torch.float32))))
