"""Triton kernel: blockwise fp32 sum-of-squares partials of [N, D] rows.

Replaces the TPU kernel ``src/repro/kernels/score_norm/kernel.py:
_sq_sum_kernel`` (entry ``sq_sum_partials``), whose function the JAX
package's client step computes for ``u_norms`` (``fl/client.py``); here it
runs row-wise over the stacked updates.

Program (n, j) loads block j of row n (masked ragged tail, zeros beyond
D), squares and sums it in fp32 and writes one partial; ``ops`` reduces
the [N, nb] partials and takes the square root outside the kernel. No
atomics, so the result does not depend on the order programs run in.

What bounds it: memory. Every input byte is read once (326 MB at the main
path's [50, 1,630,090]: 0.10 ms at 3.35 TB/s) and the partials are 0.01%
of that. The design answers with wide, fully coalesced masked loads (one
``BLOCK`` of 8192 floats per program, 8 warps) and nothing else: there is
no reuse to exploit.

Triton is imported on the first launch, not at import: the CPU tests
import this module on machines without Triton.
"""
from __future__ import annotations

import functools

import torch

tl = None  # triton.language, bound by _jit() on the first launch


def _sq_sum_rows(x_ptr, out_ptr, d, nb, BLOCK: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    blk = tl.program_id(1)
    offs = blk * BLOCK + tl.arange(0, BLOCK)
    x = tl.load(x_ptr + row * d + offs, mask=offs < d, other=0.0)
    x = x.to(tl.float32)
    tl.store(out_ptr + row * nb + blk, tl.sum(x * x, axis=0))


@functools.cache
def _jit():
    global tl
    import triton
    import triton.language as tl
    return triton.jit(_sq_sum_rows)


def sq_sum_partials(mat: torch.Tensor, out: torch.Tensor, block: int) -> None:
    """Launch on the current stream: ``out[n, j]`` = sum of squares of
    block j of row n. ``mat`` [N, D] fp32 contiguous, ``out`` [N, nb]."""
    n, d = mat.shape
    nb = out.shape[1]
    _jit()[(n, nb)](mat, out, d, nb, BLOCK=block, num_warps=8)
