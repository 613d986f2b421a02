"""The block top-k at every block width (ROADMAP B-2d), on the CPU.

* The plain versions of both kernels (``block_topk_rows`` and the rows
  entry ``block_topk_sparsify_rows``; ``block_topk_ref``) at widths 1,
  100, 128, 256, 1,000, 1,024, 2,048, 4,096 and 8,192 against the JAX
  package's sort-based oracles (``block_topk_ref``,
  ``block_topk_rows_ref``), its ``batch_block_topk(block=, skip_full=)``
  and, at three widths, its Pallas kernels in interpret mode: bit for bit.
* ``block_topk_mask_ref`` and ``effective_gamma(block=)`` against the
  reference's.
* A CPU model of the streaming kernel's passes (``csrc/topk_common.cuh:
  stream_block``, the path of blocks wider than 4,096 lanes): four 8-bit
  digit histograms over the whole block, the wrapped bisection at the
  all-ones NaN, the count of lanes above the threshold, then 4,096-lane
  tiles in index order whose ties take their rank from a carry. Its mask
  equals ``topk_threshold_mask``'s on ties, NaN, denormals, ragged tails
  and literal ks of 0 and below.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl.compression import batch_block_topk as j_batch_block_topk
from repro.fl.compression import effective_gamma as j_effective_gamma
from repro.kernels.topk_sparsify.ops import block_topk_sparsify as j_pallas
from repro.kernels.topk_sparsify.ops import block_topk_sparsify_rows as j_pallas_rows
from repro.kernels.topk_sparsify.ref import block_topk_mask_ref as j_mask_ref
from repro.kernels.topk_sparsify.ref import block_topk_ref as j_block_topk_ref
from repro.kernels.topk_sparsify.ref import block_topk_rows_ref as j_rows_ref

from repro_torch.fl.compression import batch_block_topk, effective_gamma
from repro_torch.kernels.topk_sparsify import (block_topk_mask_ref,
                                               block_topk_rows,
                                               block_topk_sparsify,
                                               block_topk_sparsify_rows)
from repro_torch.kernels.topk_sparsify.ref import daz, topk_threshold_mask

WIDTHS = (1, 100, 128, 256, 1000, 1024, 2048, 4096, 8192)
PALLAS_WIDTHS = (100, 1000, 8192)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32 if a.dtype.itemsize == 4 else np.int16)


def _values(n: int, seed: int) -> np.ndarray:
    """Normals with ties (a third on a grid of quarters) and exact zeros."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32)
    x[::3] = np.round(x[::3] * 4) / 4
    x[5::11] = 0.0
    return x


@pytest.mark.parametrize("w", WIDTHS)
def test_block_topk_at_every_width_matches_the_reference(w):
    n = 2 * w + w // 2 + 3                       # a ragged last block
    x = _values(n, w)
    for gamma in (0.1, 0.37, 1.0):
        got, k = block_topk_sparsify(torch.from_numpy(x), gamma, block=w)
        want, kj = j_block_topk_ref(jnp.asarray(x), gamma, block=w)
        assert k == kj == max(1, min(w, math.ceil(gamma * w)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            block_topk_mask_ref(torch.from_numpy(x), gamma, block=w).numpy(),
            np.asarray(j_mask_ref(jnp.asarray(x), gamma, block=w)))
    g = np.array([0.0, 1e-7, 0.1, 0.37, 0.5, 1.0], np.float32)
    np.testing.assert_array_equal(effective_gamma(torch.from_numpy(g), w).numpy(),
                                  np.asarray(j_effective_gamma(jnp.asarray(g), w)))


@pytest.mark.parametrize("w", WIDTHS)
def test_rows_at_every_width_match_the_reference(w):
    rng = np.random.default_rng(w + 1)
    # rows of the update matrix: 4 clients, two and a half blocks each
    d = 2 * w + w // 2 + 1
    mat = np.stack([_values(d, 10 * w + i) for i in range(4)])
    gamma = np.array([0.1, 1.0, 0.5, 0.03], np.float32)
    for skip in (True, False):
        got = batch_block_topk(torch.from_numpy(mat), torch.from_numpy(gamma),
                               block=w, skip_full=skip)
        # jitted, the reference's x * mask is a select: dropped lanes +0.0
        # (C-11; its eager product gives -0.0 for a dropped negative)
        want = jax.jit(lambda m, g, s=skip: j_batch_block_topk(
            m, g, block=w, skip_full=s))(jnp.asarray(mat), jnp.asarray(gamma))
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    full = np.ones(4, np.float32)
    np.testing.assert_array_equal(
        batch_block_topk(torch.from_numpy(mat), torch.from_numpy(full),
                         block=w).numpy(), mat)
    # the rows entry: [R, w] rows, per-row ks against the sort oracle
    rows = np.stack([_values(w, 20 * w + i) for i in range(6)])
    ks = rng.integers(1, w + 1, size=6).astype(np.int32)
    ks[0], ks[1] = 1, w
    got = block_topk_sparsify_rows(torch.from_numpy(rows), torch.from_numpy(ks))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_rows_ref(jnp.asarray(rows), jnp.asarray(ks))))
    # and the matrix entry at the same ks, one block a row
    np.testing.assert_array_equal(
        block_topk_rows(torch.from_numpy(rows), torch.from_numpy(ks),
                        block=w, skip_full=False).numpy(), got.numpy())


@pytest.mark.parametrize("w", PALLAS_WIDTHS)
def test_pallas_kernels_in_interpret_mode_agree_at_other_widths(w):
    x = _values(2 * w + 7, 3 * w)
    x[1] = np.nan
    x[2] = -np.inf
    for dtype in (np.float32, jnp.bfloat16):
        xv = np.asarray(jnp.asarray(x).astype(dtype))
        got, _ = block_topk_sparsify(
            torch.from_numpy(xv.astype(np.float32)).to(
                torch.float32 if dtype is np.float32 else torch.bfloat16),
            0.25, block=w)
        want, _ = j_pallas(jnp.asarray(xv), 0.25, block=w)
        want = np.asarray(want)
        got = got.float().numpy().astype(want.dtype)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    rows = np.stack([_values(w, 7 * w + i) for i in range(3)])
    rows[1, 3] = np.nan
    ks = np.array([1, w // 3 + 1, w], np.int32)
    got = block_topk_sparsify_rows(torch.from_numpy(rows), torch.from_numpy(ks))
    want = j_pallas_rows(jnp.asarray(rows), jnp.asarray(ks))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


# ---------------------------------------- a model of the streaming kernel ----
TILE, THREADS = 4096, 256


def _stream_keep(x: torch.Tensor, valid: int, n_lanes: int, k: int) -> torch.Tensor:
    """``stream_block``'s keep mask for x[:valid] (lanes [valid, n_lanes)
    compete as zeros), pass by pass as the kernel takes them."""
    bits = x[:valid].view(torch.int32) & 0x7FFFFFFF
    pad = n_lanes - valid
    wrapped = bool((bits == 0x7FFFFFFF).any())
    if wrapped:
        # the reference's bisection with hi = max + 1 wrapped to INT_MIN
        def wrap(v: int) -> int:                # int32 arithmetic
            return (v + 2**31) % 2**32 - 2**31

        lo, hi = 0, -2**31
        for _ in range(31):
            mid = wrap(lo + (wrap(hi - lo) >> 1))
            cnt = int((bits >= mid).sum()) + (pad if 0 >= mid else 0)
            lo, hi = (mid, hi) if cnt >= k else (lo, mid)
        prefix = lo
    elif k <= 0:
        prefix = 0x7F800000
    else:
        prefix, kk = 0, k
        for shift, width in ((23, 8), (15, 8), (7, 8), (0, 7)):
            top = shift + width
            match = (bits >> top) == prefix
            hist = torch.bincount(((bits[match] >> shift) & ((1 << width) - 1)).long(),
                                  minlength=1 << width)
            if prefix == 0:                  # the padding zeros match
                hist[0] += pad
            above = torch.flip(torch.cumsum(torch.flip(hist, [0]), 0), [0])
            # the bin where the kk-th largest falls, and the rank left in it
            digit = int(torch.nonzero(above >= kk).max())
            kk -= int(above[digit] - hist[digit])
            prefix = (prefix << width) | digit
    thresh = daz(torch.tensor([prefix], dtype=torch.int32)).view(torch.float32)
    mag = daz(bits).view(torch.float32)
    room = k - (int((mag > thresh).sum()) + (pad if 0.0 > float(thresh) else 0))
    keep = torch.zeros(valid, dtype=torch.bool)
    carry = 0
    for t0 in range(0, valid, TILE):
        m = mag[t0:t0 + TILE]
        eq = m == thresh
        # (p, warp) counts of the tile, scanned with the carry: index order
        counts = torch.nn.functional.pad(eq, (0, TILE - len(eq))).view(-1, 32).sum(1)
        entry = carry + torch.cumsum(counts, 0) - counts
        # inclusive count of ties in the lane's warp: popc(below) + 1
        below = torch.cumsum(torch.nn.functional.pad(eq, (0, TILE - len(eq)))
                             .view(-1, 32).int(), 1).flatten()[:len(eq)]
        rank = entry.repeat_interleave(32)[:len(eq)] + below
        keep[t0:t0 + TILE] = (m > thresh) | (eq & (rank <= room))
        carry += int(counts.sum())
    return keep


def _plain_keep(x: torch.Tensor, valid: int, n_lanes: int, k: int) -> torch.Tensor:
    row = torch.nn.functional.pad(x[:valid], (0, n_lanes - valid))
    return topk_threshold_mask(row[None], k)[0, :valid]


def _stream_cases():
    rng = np.random.default_rng(4)
    n = 3 * TILE + 517
    base = rng.normal(size=n).astype(np.float32)
    ties = np.round(base * 2) / 2
    nan = base.copy()
    nan[::7] = np.nan
    nan[1::13] = np.inf
    den = np.zeros(n, np.float32)
    den[::5] = rng.normal(size=len(den[::5]))
    den.view(np.int32)[3::7] = rng.integers(1, 1 << 23, size=len(den[3::7]))
    ones = base.copy()
    ones.view(np.int32)[100] = 0x7FFFFFFF
    return {"normal": base, "ties": ties, "nan_inf": nan, "denormals": den,
            "all_ones_nan": ones}


@pytest.mark.parametrize("case", ["normal", "ties", "nan_inf", "denormals",
                                  "all_ones_nan"])
def test_streaming_model_keeps_the_plain_mask(case):
    x = torch.from_numpy(_stream_cases()[case])
    n = x.numel()
    for valid, n_lanes in ((n, n), (n - 3000, n), (TILE + 1, 2 * TILE)):
        for k in (1, 2, 17, n_lanes // 3, n_lanes // 2 + 1, n_lanes - 1, 0, -4):
            got = _stream_keep(x, valid, n_lanes, k)
            want = _plain_keep(x, valid, n_lanes, k)
            assert torch.equal(got, want), (case, valid, n_lanes, k)
