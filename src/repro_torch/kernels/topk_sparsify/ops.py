"""Wrapper of the per-row block top-k kernel (``csrc/topk_rows.cu``).

``block_topk_rows(mat, ks)`` sparsifies every ``ref.DEFAULT_BLOCK``-wide
block of row n of ``mat`` [N, D] to its ``ks[n]`` largest magnitudes
(``ref.block_topk_rows`` is the same function in plain PyTorch, run for
CPU tensors). The kernel reads the ragged last block of each row in
place, so no padded copy of the [N, D] matrix is made.
"""
from __future__ import annotations

import torch

from .. import _build, check_cuda, is_cpu
from .ref import block_topk_rows as block_topk_rows_plain


def block_topk_rows(mat: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    if is_cpu(mat):
        return block_topk_rows_plain(mat, ks)
    dev = mat.device
    check_cuda("mat", mat, dtype=torch.float32, ndim=2, device=dev)
    check_cuda("ks", ks, dtype=torch.int32, ndim=1, device=dev)
    n, d = mat.shape
    if ks.shape[0] != n:
        raise ValueError(f"ks has {ks.shape[0]} rows, mat has {n}")
    out = torch.empty_like(mat)
    err = _build.library().topk_rows_f32(
        mat.data_ptr(), out.data_ptr(), ks.data_ptr(), n, d,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "topk_rows_f32")
    block_topk_rows.launches += 1
    return out


block_topk_rows.launches = 0
