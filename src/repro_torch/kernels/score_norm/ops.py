"""Wrappers of the row sum-of-squares Triton kernel: L2 norms.

``row_l2_norms(mat)`` is the port's ``u_norms`` for the stacked client
updates [N, D]: CPU tensors run ``ref.row_l2_norms_ref``; CUDA tensors
launch ``kernel.sq_sum_partials`` over a (N, ceil(D / BLOCK)) grid, and
the [N, nb] partials are summed (in float64, ``ref.norms_from_partials``)
and square-rooted outside the kernel, as
``repro.kernels.score_norm.ops.l2_norm`` does with its partials.

``l2_norm(vec, block=)`` is the norm of one vector, the JAX package's
entry: on the CPU ``ref.l2_norm_blocks`` (the reference's block rule), on
the card the same kernel on the vector as one row.
"""
from __future__ import annotations

import torch

from .. import check_cuda, is_cpu
from .ref import l2_norm_blocks, norms_from_partials, row_l2_norms_ref

BLOCK = 8192


def _norms(mat: torch.Tensor) -> torch.Tensor:
    """The kernel's partials of the CUDA rows ``mat`` [N, D], summed and
    square-rooted: [N] norms."""
    check_cuda("mat", mat, dtype=torch.float32, ndim=2, device=mat.device)
    n, d = mat.shape
    partials = torch.empty((n, -(-d // BLOCK)), dtype=torch.float32,
                           device=mat.device)
    from .kernel import sq_sum_partials
    sq_sum_partials(mat, partials, BLOCK)
    return norms_from_partials(partials)


def row_l2_norms(mat: torch.Tensor) -> torch.Tensor:
    if is_cpu(mat):
        return row_l2_norms_ref(mat, BLOCK)
    out = _norms(mat)
    row_l2_norms.launches += 1
    return out


row_l2_norms.launches = 0


def l2_norm(vec: torch.Tensor, *, block: int = 65536) -> torch.Tensor:
    """||vec||_2 of a 1-D vector as a 0-d fp32 tensor. The CPU runs the
    reference's rule (``ref.l2_norm_blocks``: blocks of ``min(block,
    max(128, next power of two >= n))`` lanes, zero padded, fp32 partials).
    On the card the row kernel takes the vector as one row at its own
    ``BLOCK`` (8,192 lanes a program: a Triton program does not hold a
    65,536-wide block well); its partials are summed in float64 and rounded
    once, so only the order of the fp32 sums inside a block differs
    (within fp32 rtol 1e-6)."""
    if vec.ndim != 1:
        raise ValueError(f"vec has shape {tuple(vec.shape)}, expected 1 dim")
    if block < 1:
        raise ValueError(f"block must be at least 1, got {block}")
    if is_cpu(vec):
        return l2_norm_blocks(vec, block)
    if vec.shape[0] == 0:
        return vec.new_zeros(())
    out = _norms(vec[None])[0]
    l2_norm.launches += 1
    return out


l2_norm.launches = 0
