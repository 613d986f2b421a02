"""Wrappers of the block top-k kernels.

``block_topk_rows(mat, ks, block=)`` (``csrc/topk_rows.cu``) sparsifies
every ``block``-wide block of row n of ``mat`` [N, D] to its ``ks[n]``
largest magnitudes; ``block_topk_sparsify_rows(rows, ks)`` is the same
kernel on ``[R, block]`` rows with the reference's literal k and no
all-full skip (the rows entry of the JAX package). ``block_topk_sparsify(
vec, gamma, block=)`` (``csrc/topk_block.cu``) keeps ``ref.keep_count(gamma,
block)`` per block of a 1-D fp32, bf16 or fp16 vector. Each runs its plain
PyTorch version (``ref.block_topk_rows``, ``ref.block_topk_sparsify_rows``,
``ref.block_topk_ref``) for CPU tensors. Any block width from 1 up to a
whole row runs on either device: the kernels hold a block of up to 4,096
lanes in registers (one instance a power of two of 256-lane steps) and
stream a wider one from device memory; a width the card's int lane
indices cannot take (``MAX_BLOCK``) raises on a CUDA tensor. The kernels
read the ragged last block in place, so no padded copy is made; they find
each block's k-th largest magnitude by a 4-pass radix select
(``csrc/topk_common.cuh``), which gives the plain version's bisection
threshold bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, check_cuda, is_cpu
from .ref import DEFAULT_BLOCK, block_topk_ref, keep_count
from .ref import block_topk_rows as block_topk_rows_plain
from .ref import block_topk_sparsify_rows as block_topk_sparsify_rows_plain

# csrc/topk_common.cuh: kMaxStreamBlock, int lane indices with a 4,096-lane
# tile to spare
MAX_BLOCK = 2**31 - 1 - 4096
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SKIP_FULL, _CLIP_K = 1, 2                # csrc/topk_rows.cu: the flags


def _check_block(block: int, on_card: bool) -> None:
    if block < 1:
        raise ValueError(f"block must be at least 1, got {block}")
    if on_card and block > MAX_BLOCK:
        raise ValueError(f"block {block} is wider than the kernels take on "
                         f"the card ({MAX_BLOCK})")


def _launch_rows(mat: torch.Tensor, ks: torch.Tensor, block: int,
                 flags: int) -> torch.Tensor:
    dev = mat.device
    check_cuda("mat", mat, dtype=torch.float32, ndim=2, device=dev)
    check_cuda("ks", ks, dtype=torch.int32, ndim=1, device=dev)
    _check_block(block, True)
    n, d = mat.shape
    if ks.shape[0] != n:
        raise ValueError(f"ks has {ks.shape[0]} rows, mat has {n}")
    out = torch.empty_like(mat)
    err = _build.library().topk_rows_f32(
        mat.data_ptr(), out.data_ptr(), ks.data_ptr(), n, d, block, flags,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "topk_rows_f32")
    block_topk_rows.launches += 1
    return out


def block_topk_rows(mat: torch.Tensor, ks: torch.Tensor, *,
                    block: int = DEFAULT_BLOCK,
                    skip_full: bool = True) -> torch.Tensor:
    """``mat`` [N, D] fp32 with the top ``ks[n]`` (clipped to [1, block])
    magnitudes of every ``block``-wide block of row n kept; with
    ``skip_full`` the matrix copies through when every ``ks[n] >= block``."""
    _check_block(block, False)
    if is_cpu(mat):
        return block_topk_rows_plain(mat, ks, block=block, skip_full=skip_full)
    return _launch_rows(mat, ks, block, _CLIP_K | (_SKIP_FULL if skip_full else 0))


block_topk_rows.launches = 0


def block_topk_sparsify_rows(rows: torch.Tensor, ks: torch.Tensor
                             ) -> torch.Tensor:
    """rows [R, block] fp32, ks [R] int32: the top ``ks[r]`` magnitudes of
    row r kept, k as the reference's Pallas rows kernel takes it (no clip,
    no all-full skip). On the card it is the rows kernel, whose launches it
    counts in ``block_topk_rows.launches``."""
    if rows.ndim != 2 or ks.ndim != 1 or ks.shape[0] != rows.shape[0]:
        raise ValueError(f"rows {tuple(rows.shape)} and ks {tuple(ks.shape)} "
                         "are not [R, block] and [R]")
    _check_block(rows.shape[1], False)
    if is_cpu(rows):
        return block_topk_sparsify_rows_plain(rows, ks)
    return _launch_rows(rows, ks, rows.shape[1], 0)


def block_topk_sparsify(vec: torch.Tensor, gamma, *,
                        block: int = DEFAULT_BLOCK) -> tuple[torch.Tensor, int]:
    """(vec with the top ``k`` magnitudes of each ``block``-wide block kept,
    k); any ``block`` from 1, on either device (up to ``MAX_BLOCK`` on the
    card)."""
    _check_block(block, False)
    if vec.ndim != 1:
        raise ValueError(f"vec has shape {tuple(vec.shape)}, expected 1 dim")
    if is_cpu(vec):
        return block_topk_ref(vec, gamma, block=block)
    if vec.dtype not in _DTYPE_CODES:
        raise TypeError(f"vec has dtype {vec.dtype}, expected float32, "
                        "bfloat16 or float16")
    check_cuda("vec", vec, dtype=vec.dtype, ndim=1, device=vec.device)
    _check_block(block, True)
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


def kernel_attributes(kernel: str, dtype: torch.dtype = torch.float32, *,
                      block: int = DEFAULT_BLOCK) -> dict:
    """Registers a thread, spill (local) bytes a thread, and static and
    dynamic shared bytes a CTA of the ``"rows"`` kernel's or the
    ``"block"`` kernel's instance (for ``dtype``) that takes blocks of
    ``block`` lanes."""
    out = (ctypes.c_int * 4)()
    lib = _build.library()
    if kernel == "rows":
        err = lib.topk_rows_attrs(block, out)
    elif kernel == "block":
        err = lib.topk_block_attrs(_DTYPE_CODES[dtype], block, out)
    else:
        raise ValueError(f"kernel must be 'rows' or 'block', got {kernel!r}")
    _build.check(err, f"topk_{kernel}_attrs")
    return {"registers": out[0], "local_bytes": out[1],
            "shared_bytes": out[2], "dynamic_shared_bytes": out[3]}
