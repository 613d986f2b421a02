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
whole row runs on either device; a width the card's int lane indices
cannot take (``MAX_BLOCK``) raises on a CUDA tensor. On the card the width
picks one of four tiers (``tier``, ``csrc/topk_common.cuh``):

* ``"narrow"`` (1-255 lanes): a CTA takes a span of up to 4,096 lanes of
  consecutive blocks, each warp selecting its blocks; one launch a call.
* ``"register"`` (256-4,096): one CTA a block, held in registers (one
  instance a power of two of 256-lane steps); one launch.
* ``"staged"`` (up to ``STAGE_BYTES`` a block: 49,152 fp32 lanes, 98,304
  16-bit): one CTA a block, staged whole in shared memory; one launch.
* ``"chunked"`` (wider): one CTA a ``CHUNK`` of a block, over six launches
  (a clear of the workspace, four digit passes, the write) that share a
  workspace this wrapper allocates (``torch.empty``).

The kernels read the ragged last block in place, so no padded copy is
made; they find each block's k-th largest magnitude by a radix select, a
bisection or per-lane ranks, each giving the plain version's threshold bit
for bit. ``launches`` counts wrapper calls that reached a kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, check_cuda, is_cpu
from .ref import DEFAULT_BLOCK, block_topk_ref, keep_count
from .ref import block_topk_rows as block_topk_rows_plain
from .ref import block_topk_sparsify_rows as block_topk_sparsify_rows_plain

# csrc/topk_common.cuh: kMaxWidth, int lane indices with a 4,096-lane tile
# to spare; the tiers' limits (kNarrowMax, kMaxBlock, kStageBytes, kChunk);
# the chunked tier's workspace words a block and a chunk (kHeaderWords,
# kChunkWords)
MAX_BLOCK = 2**31 - 1 - 4096
NARROW_MAX, REGISTER_MAX, STAGE_BYTES, CHUNK = 255, 4096, 196608, 8192
_HEADER_WORDS, _CHUNK_WORDS = 1024, 129
_CHUNK_LAUNCHES = 6        # the workspace's clear, four digit passes, the write
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SKIP_FULL, _CLIP_K = 1, 2                # csrc/topk_rows.cu: the flags


def _check_block(block: int, on_card: bool) -> None:
    if block < 1:
        raise ValueError(f"block must be at least 1, got {block}")
    if on_card and block > MAX_BLOCK:
        raise ValueError(f"block {block} is wider than the kernels take on "
                         f"the card ({MAX_BLOCK})")


def tier(block: int, dtype: torch.dtype = torch.float32) -> str:
    """The kernel tier that takes blocks of ``block`` lanes of ``dtype``."""
    if block <= NARROW_MAX:
        return "narrow"
    if block <= REGISTER_MAX:
        return "register"
    if block * torch.finfo(dtype).bits // 8 <= STAGE_BYTES:
        return "staged"
    return "chunked"


def launches_per_call(block: int, dtype: torch.dtype = torch.float32) -> int:
    """CUDA launches one wrapper call makes at ``block`` lanes of ``dtype``."""
    return _CHUNK_LAUNCHES if tier(block, dtype) == "chunked" else 1


def _workspace(n_blocks: int, block: int, dtype: torch.dtype,
               device: torch.device) -> tuple[torch.Tensor | None, int, int]:
    """(buffer, pointer, words) of the chunked tier's workspace for
    ``n_blocks`` blocks; (None, 0, 0) for another tier. The caller holds the
    buffer until the launch is queued; the caching allocator hands its
    memory on only to work queued after the kernels on the stream."""
    if tier(block, dtype) != "chunked":
        return None, 0, 0
    words = n_blocks * (_HEADER_WORDS + -(-block // CHUNK) * _CHUNK_WORDS)
    ws = torch.empty(words, dtype=torch.int32, device=device)
    return ws, ws.data_ptr(), words


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
    _ws, ws, words = _workspace(n * -(-d // block), block, mat.dtype, dev)
    err = _build.library().topk_rows_f32(
        mat.data_ptr(), out.data_ptr(), ks.data_ptr(), n, d, block, flags, ws,
        words, torch.cuda.current_stream(dev).cuda_stream)
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
    _ws, ws, words = _workspace(-(-vec.numel() // block), block, vec.dtype,
                                vec.device)
    err = _build.library().topk_block(vec.data_ptr(), out.data_ptr(),
                                      vec.numel(), block, k,
                                      _DTYPE_CODES[vec.dtype], ws, words,
                                      stream)
    _build.check(err, "topk_block")
    block_topk_sparsify.launches += 1
    return out, k


block_topk_sparsify.launches = 0


def kernel_attributes(kernel: str, dtype: torch.dtype = torch.float32, *,
                      block: int = DEFAULT_BLOCK) -> dict:
    """Registers a thread, spill (local) bytes a thread, static shared
    bytes a CTA, and the dynamic shared bytes it is launched with, of the
    ``"rows"`` or the ``"block"`` kernel (for ``dtype``) that takes blocks
    of ``block`` lanes (the chunked tier: its pass kernel), with its tier
    and its launches a call."""
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
            "shared_bytes": out[2], "dynamic_shared_bytes": out[3],
            "tier": tier(block, dtype),
            "launches_per_call": launches_per_call(block, dtype)}
