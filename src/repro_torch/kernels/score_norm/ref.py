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


def row_l2_norms_ref(mat: Tensor, block: int) -> Tensor:
    """[N, D] -> [N] row L2 norms."""
    return torch.sqrt(torch.sum(sq_sum_partials_ref(mat, block), dim=1))
