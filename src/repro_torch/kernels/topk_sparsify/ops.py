"""Wrappers of the block top-k kernels.

``block_topk_rows(mat, ks)`` (``csrc/topk_rows.cu``) sparsifies every
``ref.DEFAULT_BLOCK``-wide block of row n of ``mat`` [N, D] to its
``ks[n]`` largest magnitudes. ``block_topk_sparsify(vec, gamma, block=)``
(``csrc/topk_block.cu``) keeps ``ref.keep_count(gamma, block)`` per block
of a 1-D fp32 or bf16 vector. Each runs its plain PyTorch version
(``ref.block_topk_rows``, ``ref.block_topk_ref``) for CPU tensors. The
kernels read the ragged last block in place, so no padded copy is made;
they find each block's k-th largest magnitude by a 4-pass radix select
(``csrc/topk_common.cuh``), which gives the plain version's bisection
threshold bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, check_cuda, is_cpu
from .ref import DEFAULT_BLOCK, block_topk_ref, keep_count
from .ref import block_topk_rows as block_topk_rows_plain

MAX_BLOCK = 4096                  # csrc/topk_common.cuh: kMaxBlock lanes a CTA
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def block_topk_sparsify(vec: torch.Tensor, gamma, *,
                        block: int = DEFAULT_BLOCK) -> tuple[torch.Tensor, int]:
    """(vec with the top ``k`` magnitudes of each ``block``-wide block kept,
    k); ``block`` is a multiple of 128 up to ``MAX_BLOCK``, as the Pallas
    kernel's lane tiling asks, on either device."""
    if block % 128 or not 128 <= block <= MAX_BLOCK:
        raise ValueError(f"block must be a multiple of 128 up to {MAX_BLOCK}, "
                         f"got {block}")
    if is_cpu(vec):
        return block_topk_ref(vec, gamma, block=block)
    if vec.dtype not in _DTYPE_CODES:
        raise TypeError(f"vec has dtype {vec.dtype}, expected float32 or "
                        "bfloat16")
    check_cuda("vec", vec, dtype=vec.dtype, ndim=1, device=vec.device)
    k = keep_count(gamma, block)
    out = torch.empty_like(vec)
    if vec.numel() == 0:
        return out, k
    stream = torch.cuda.current_stream(vec.device).cuda_stream
    err = _build.library().topk_block(vec.data_ptr(), out.data_ptr(),
                                      vec.numel(), block, k,
                                      _DTYPE_CODES[vec.dtype], stream)
    _build.check(err, "topk_block")
    block_topk_sparsify.launches += 1
    return out, k


block_topk_sparsify.launches = 0


def kernel_attributes(kernel: str, dtype: torch.dtype = torch.float32) -> dict:
    """Registers a thread, spill (local) bytes a thread, and static and
    dynamic shared bytes a CTA of the compiled ``"rows"`` kernel or of the
    ``"block"`` kernel's instance for ``dtype``."""
    out = (ctypes.c_int * 4)()
    lib = _build.library()
    if kernel == "rows":
        err = lib.topk_rows_attrs(out)
    elif kernel == "block":
        err = lib.topk_block_attrs(_DTYPE_CODES[dtype], out)
    else:
        raise ValueError(f"kernel must be 'rows' or 'block', got {kernel!r}")
    _build.check(err, f"topk_{kernel}_attrs")
    return {"registers": out[0], "local_bytes": out[1],
            "shared_bytes": out[2], "dynamic_shared_bytes": out[3]}
