"""Plain PyTorch version of block-local magnitude top-k sparsification.

Semantics (the JAX package's, bit for bit): the flat vector is split into
fixed blocks; in each block exactly ``k`` coefficients are kept — those
with the largest |x|, ties broken by index order (earlier index wins).
Trailing padding (zeros) competes like any other value but the result is
truncated back to the input length.

``topk_threshold_mask`` is the sort-free rule the CUDA kernel
(``csrc/topk_rows.cu``) implements: it finds the exact k-th largest
magnitude by bisecting on the fp32 *bit pattern* (non-negative floats
order as their int32 bits, so 31 integer halvings pin the threshold), then
applies the float tests ``mag > thresh`` / ``mag == thresh`` and fills the
ties by an inclusive cumulative count. The float tests compare as the
reference's platform, XLA on the CPU, does: with denormals as zero, so a
magnitude or threshold whose exponent field is 0 compares as 0.0 (ROADMAP
C-16); the bisection works on the raw bits, as the reference's does.
``block_topk_rows_ref`` is the reference's sort-based oracle of the same
mask on normal numbers.

Three functions of the kernels, at any block width: ``block_topk_rows``
(one k per row of a stacked ``[N, D]`` update matrix,
``csrc/topk_rows.cu``), ``block_topk_sparsify_rows`` (the rows entry: a k
per ``[R, block]`` row, the same kernel) and ``block_topk_ref`` (one
static k for a 1-D vector, ``csrc/topk_block.cu``); ``block_topk_mask_ref``
is the keep mask of ``block_topk_ref``.

Dropped lanes are +0.0 — ``torch.where(mask, x, 0)`` — which is what the
reference's jitted ``x * mask`` returns (XLA rewrites the product into a
select), so a dropped NaN, Inf or negative value comes out as +0.0.
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

DEFAULT_BLOCK = 4096   # the block width of the round's sparsify


def daz(bits: Tensor) -> Tensor:
    """int32 float patterns with the denormals (exponent field 0, either
    sign) set to +0.0: what a float compare on XLA's CPU sees, since it
    runs with denormals as zero."""
    return torch.where((bits & 0x7F800000) == 0, 0, bits)


def widen_f16(x: Tensor) -> Tensor:
    """fp16 ``x`` as the fp32 values the kernels compare, by integer
    operations: a NaN quiet with its sign and payload kept (sign,
    0x7fc00000, payload << 13), every other lane exact. Torch's conversion
    does so for a NaN in its CPU vector loop but gives 0x7fffffff in the
    loop's scalar tail, and on the card for every NaN (ROADMAP C-31); the
    reference's XLA:CPU convert and the kernels widen as here."""
    b = x.view(torch.int16).to(torch.int32) & 0xFFFF
    nan = ((b & 0x7C00) == 0x7C00) & ((b & 0x3FF) != 0)
    quiet = ((b & 0x8000) << 16) | 0x7FC00000 | ((b & 0x3FF) << 13)
    return torch.where(nan, quiet, x.to(torch.float32).view(torch.int32)
                       ).view(torch.float32)


def topk_threshold_mask(x: Tensor, k) -> Tensor:
    """Keep-mask of the top-k magnitudes per row, ties to the lower index.

    x: [..., block] float; k: int tensor broadcastable to [..., 1],
    clipped by the caller to [1, block]. int32 arithmetic wraps, as the
    reference's does. |x| is taken on the bits (clear the sign), which
    keeps a NaN's payload on every device, as XLA's abs does on the CPU;
    ``torch.abs`` on a CUDA tensor returns the canonical NaN instead. The
    float tests see denormals as zero (``daz``), as the reference's do.
    fp16 widens by ``widen_f16``, wherever its NaNs fall."""
    wide = widen_f16(x) if x.dtype == torch.float16 else x.to(torch.float32)
    bits = wide.view(torch.int32) & 0x7FFFFFFF
    k = torch.as_tensor(k, dtype=torch.int32, device=x.device)
    k = k.expand(*bits.shape[:-1], 1)

    # invariant: count(bits >= lo) >= k, count(bits >= hi) < k
    lo = torch.zeros_like(k)
    hi = torch.amax(bits, dim=-1, keepdim=True) + 1
    for _ in range(31):
        mid = lo + torch.div(hi - lo, 2, rounding_mode="floor")
        enough = (bits >= mid).sum(dim=-1, keepdim=True, dtype=torch.int32) >= k
        lo, hi = torch.where(enough, mid, lo), torch.where(enough, hi, mid)
    # the k-th largest |x|, and the float tests with denormals as zero
    thresh = daz(lo).view(torch.float32)
    mag = daz(bits).view(torch.float32)
    greater = mag > thresh
    n_greater = greater.sum(dim=-1, keepdim=True, dtype=torch.int32)
    equal = mag == thresh
    fill = torch.cumsum(equal.to(torch.int32), dim=-1) <= (k - n_greater)
    return greater | (equal & fill)


def block_topk_rows_ref(rows: Tensor, ks: Tensor) -> Tensor:
    """Sort-based oracle: rows [R, block], ks [R] (clipped to [1, block]).
    Per row, the ``ks[r]`` largest magnitudes, ties by index order."""
    block = rows.shape[1]
    ks = torch.clamp(ks.to(torch.int64), 1, block)
    mag = torch.abs(rows.to(torch.float32))
    srt = torch.sort(mag, dim=1).values                           # ascending
    kth = torch.gather(srt, 1, (block - ks)[:, None])             # [R,1]
    greater = mag > kth
    n_greater = greater.sum(dim=1, keepdim=True)
    equal = mag == kth
    fill = torch.cumsum(equal.to(torch.int32), dim=1) <= (ks[:, None] - n_greater)
    mask = greater | (equal & fill)
    return torch.where(mask, rows, 0.0)


def block_topk_rows(mat: Tensor, ks: Tensor, *, block: int = DEFAULT_BLOCK,
                    skip_full: bool = True) -> Tensor:
    """The kernel's function in plain PyTorch: ``mat`` [N, D] fp32 split
    into ``block``-wide blocks per row (the ragged tail zero-padded), the
    top ``ks[n]`` magnitudes kept in every block of row n, ``ks`` clipped
    to [1, block]. With ``skip_full``, when every ``ks[n] >= block`` the
    matrix copies through (the reference's all-full skip); otherwise such a
    row takes the mask at k = block, which drops only NaN lanes. Returns
    [N, D]."""
    n, d = mat.shape
    if skip_full and bool(torch.all(ks >= block)):
        return mat.clone()
    nb = -(-d // block)
    rows = torch.nn.functional.pad(mat, (0, nb * block - d)).reshape(n * nb, block)
    ks_rows = torch.repeat_interleave(ks.to(torch.int32), nb)[:, None]
    mask = topk_threshold_mask(rows, torch.clamp(ks_rows, 1, block))
    return torch.where(mask, rows, 0.0).reshape(n, nb * block)[:, :d]


def block_topk_sparsify_rows(rows: Tensor, ks: Tensor) -> Tensor:
    """The rows entry in plain PyTorch: ``rows`` [R, block], the top
    ``ks[r]`` magnitudes of row r kept, ties to the lower index, as the
    reference's Pallas rows kernel keeps them: k as given (the caller
    clips it; at k <= 0 the bisection keeps nothing, at k >= block every
    lane but a NaN), no all-full skip. Dropped lanes are +0.0."""
    mask = topk_threshold_mask(rows, ks.to(torch.int32)[:, None])
    return torch.where(mask, rows, 0.0)


def keep_count(gamma, block: int) -> int:
    """k = clip(ceil(gamma * block), 1, block), in Python doubles as the
    reference computes it for a static gamma."""
    return max(1, min(block, math.ceil(float(gamma) * block)))


def _pad_to_blocks(vec: Tensor, block: int) -> tuple[Tensor, int]:
    n = vec.shape[0]
    nb = -(-n // block)
    rows = torch.nn.functional.pad(vec, (0, nb * block - n))
    return rows.reshape(nb, block), n


def block_topk_ref(vec: Tensor, gamma, *, block: int = DEFAULT_BLOCK
                   ) -> tuple[Tensor, int]:
    """The kernel's function in plain PyTorch: ``vec`` [n] (fp32, bf16 or fp16)
    cut into ``block``-wide blocks (the ragged tail zero-padded, then cut
    off again), the ``k = keep_count(gamma, block)`` largest magnitudes of
    every block kept, in the input's dtype. Returns (vector, k).

    The mask is ``topk_threshold_mask`` on the fp32 values; there is no
    all-full skip, so at k = block the NaN lanes are dropped. Dropped lanes
    are +0.0, as in the reference's Pallas kernel and its jitted fp32
    ``block_topk_ref``; its eager one, and its jitted one in bf16, give
    the IEEE product ``x * 0`` instead (ROADMAP C-11)."""
    if vec.ndim != 1:
        raise ValueError(f"vec has shape {tuple(vec.shape)}, expected 1 dim")
    k = keep_count(gamma, block)
    rows, n = _pad_to_blocks(vec, block)
    mask = topk_threshold_mask(rows, k)
    return torch.where(mask, rows, 0.0).reshape(-1)[:n], k


def block_topk_mask_ref(vec: Tensor, gamma, *, block: int = DEFAULT_BLOCK
                        ) -> Tensor:
    """The keep mask of ``block_topk_ref``: its output's nonzero lanes."""
    out, _ = block_topk_ref(vec, gamma, block=block)
    return out != 0
