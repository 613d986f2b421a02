"""Wrapper of the row sum-of-squares Triton kernel: per-row L2 norms.

``row_l2_norms(mat)`` is the port's ``u_norms`` for the stacked client
updates [N, D]: CPU tensors run ``ref.row_l2_norms_ref``; CUDA tensors
launch ``kernel.sq_sum_partials`` over a (N, ceil(D / BLOCK)) grid, and
the [N, nb] partials are summed (in float64, ``ref.norms_from_partials``)
and square-rooted outside the kernel, as
``repro.kernels.score_norm.ops.l2_norm`` does with its partials.
"""
from __future__ import annotations

import torch

from .. import check_cuda, is_cpu
from .ref import norms_from_partials, row_l2_norms_ref

BLOCK = 8192


def row_l2_norms(mat: torch.Tensor) -> torch.Tensor:
    if is_cpu(mat):
        return row_l2_norms_ref(mat, BLOCK)
    check_cuda("mat", mat, dtype=torch.float32, ndim=2, device=mat.device)
    n, d = mat.shape
    partials = torch.empty((n, -(-d // BLOCK)), dtype=torch.float32,
                           device=mat.device)
    from .kernel import sq_sum_partials
    sq_sum_partials(mat, partials, BLOCK)
    row_l2_norms.launches += 1
    return norms_from_partials(partials)


row_l2_norms.launches = 0
