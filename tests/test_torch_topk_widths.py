"""The block top-k at every block width (ROADMAP B-2d), on the CPU.

* The plain versions of both kernels (``block_topk_rows`` and the rows
  entry ``block_topk_sparsify_rows``; ``block_topk_ref``) at widths 1,
  100, 128, 256, 1,000, 1,024, 2,048, 4,096 and 8,192 against the JAX
  package's sort-based oracles (``block_topk_ref``,
  ``block_topk_rows_ref``), its ``batch_block_topk(block=, skip_full=)``
  and, at three widths, its Pallas kernels in interpret mode: bit for bit.
* ``block_topk_mask_ref`` and ``effective_gamma(block=)`` against the
  reference's.
* CPU models of the card's tiers past the register one
  (``csrc/topk_common.cuh``), each equal to ``topk_threshold_mask`` on
  normals, ties, NaN and +-Inf, denormals and the all-ones NaN, at literal
  ks of 0 and below: the chunked tier (per-chunk histograms summed into the
  block's, the picks replayed, the closed forms of the threshold at 0.0 and
  for the all-ones NaN, the write's tie carry from the chunks before, a
  ragged last chunk, one chunk as the staged tier, k at a chunk edge, a run
  of ties over a chunk edge); the narrow tier at widths 1 to 255 (segments
  of a warp row, their k-th pattern by per-lane ranks, or a block over the
  warp's rows by bisection; the same closed forms; ties in lane order),
  and its CTA spans tiling the matrix.
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


# ------------------------------------------------ models of the card's tiers ----
# csrc/topk_common.cuh: the chunked tier's chunk and the tile its ties are
# ranked in; the narrow tier's lanes a warp; the exponent's digit first
CHUNK, TILE, WARP_SPAN = 8192, 4096, 512
DIGITS = ((23, 8), (15, 8), (7, 8), (0, 7))     # (shift, bits)


def _daz_float(bits: torch.Tensor) -> torch.Tensor:
    return daz(bits.to(torch.int32)).view(torch.float32)


def _pick(hist: torch.Tensor, kk: int) -> tuple[int, int, int]:
    """pick_digit: the bin holding the kk-th largest pattern (bins summed
    from the top), the rank left in it and the bin's count."""
    above = torch.flip(torch.cumsum(torch.flip(hist, [0]), 0), [0])
    d = int(torch.nonzero(above >= kk).max())
    return d, kk - int(above[d] - hist[d]), int(hist[d])


def _tile_ranks(eq: torch.Tensor, carry: int) -> torch.Tensor:
    """keep_lanes' tie ranks over a chunk's lanes: tiles of 4,096 lanes,
    each a scan of its (p, warp) ballot counts from the carry plus the
    popcount below the lane, the carry moving on a tile at a time."""
    ranks = []
    for t0 in range(0, len(eq), TILE):
        t = eq[t0:t0 + TILE]
        groups = torch.nn.functional.pad(t, (0, TILE - len(t))).view(-1, 32).int()
        counts = groups.sum(1)
        entry = carry + torch.cumsum(counts, 0) - counts
        ranks.append((entry[:, None] + torch.cumsum(groups, 1)).flatten()[:len(t)])
        carry += int(counts.sum())
    return torch.cat(ranks) if ranks else torch.zeros(0, dtype=torch.int64)


def _chunked_keep(x: torch.Tensor, valid: int, n_lanes: int, k: int,
                  chunk: int = CHUNK) -> torch.Tensor:
    """``chunk_pass``'s keep mask for the block x[:valid] of n_lanes lanes
    (the rest compete as zeros), launch by launch: each chunk's histograms
    summed into the block's, the picks replayed from them, the closed forms
    of the threshold and its counts, and the write, whose ties take their
    rank after the ties of the chunks before (each chunk's record). One
    chunk is the staged tier (``staged_select``: the same digits and
    forms in one CTA)."""
    bits = (x[:valid].view(torch.int32) & 0x7FFFFFFF).long()
    if k >= n_lanes:                           # every lane but a NaN
        return bits <= 0x7F800000
    pad = n_lanes - valid
    chunks = [bits[c:c + chunk] for c in range(0, n_lanes, chunk)]
    hist = [torch.zeros(1 << w, dtype=torch.int64) for _, w in DIGITS]
    zeros_rec, last_rec = [], []
    # launch 0: the exponent, the NaNs, the all-ones NaN
    n_nan, ones = 0, False
    for c, b in enumerate(chunks):
        h = torch.bincount(b >> 23, minlength=256)
        zeros_rec.append(int(h[0]))
        if c == 0:
            h[0] += pad
        hist[0] += h
        n_nan += int((b > 0x7F800000).sum())
        ones |= bool((b == 0x7FFFFFFF).any())

    def replay(passes: int):
        if ones:
            return "zero", 0, k, 0
        if k <= 0:
            return "nothing", 0, k, 0
        prefix, kk, count = 0, k, 0
        for p in range(passes):
            digit, kk, count = _pick(hist[p], kk)
            prefix = (prefix << DIGITS[p][1]) | digit
            if p == 0 and digit == 0:
                return "zero", prefix, kk, count
        return "picking", prefix, kk, count

    # launches 1-3: the digits under the prefix picked so far
    for p in range(1, 4):
        mode, prefix, _, _ = replay(p)
        if mode != "picking":
            break
        shift, width = DIGITS[p]
        for b in chunks:
            m = b[(b >> (shift + width)) == prefix]
            h = torch.bincount((m >> shift) & ((1 << width) - 1), minlength=1 << width)
            hist[p] += h
            if p == 3:
                last_rec.append(h)
    # launch 4: the verdict, and the write chunk by chunk
    mode, prefix, kk, count = replay(4)
    if mode == "zero":
        thresh, n_eq = 0.0, int(hist[0][0]) - pad
        room = k - (n_lanes - int(hist[0][0]) - n_nan)
    elif mode == "nothing":
        thresh, room, n_eq = math.inf, k, 0
    elif prefix > 0x7F800000:
        thresh, room, n_eq = math.nan, 0, 0
    else:
        thresh = float(torch.tensor([prefix], dtype=torch.int32).view(torch.float32))
        room, n_eq = kk + n_nan, count
    keep = []
    for c, b in enumerate(chunks):
        mag = _daz_float(b)
        gt, eq = mag > thresh, mag == thresh
        if room <= 0 or n_eq <= room:          # no tie to rank
            keep.append(gt | (eq & (room > 0)))
            continue
        rec = zeros_rec if mode == "zero" else [int(h[prefix & 127]) for h in last_rec]
        keep.append(gt | (eq & (_tile_ranks(eq, sum(rec[:c])) <= room)))
    return torch.cat(keep)


def _plain_keep(x: torch.Tensor, valid: int, n_lanes: int, k: int) -> torch.Tensor:
    row = torch.nn.functional.pad(x[:valid], (0, n_lanes - valid))
    return topk_threshold_mask(row[None], k)[0, :valid]


def _cases(n: int, seed: int) -> dict:
    """normals; ties (a grid of halves); NaN and +-Inf; denormals among
    normals and zeros; normals beside a NaN of every mantissa bit set
    (0x7fffffff) late in the block."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=n).astype(np.float32)
    ties = np.round(base * 2) / 2
    nan = base.copy()
    nan[::7] = np.nan
    nan[1::13] = np.inf
    nan[2::17] = -np.inf
    den = np.zeros(n, np.float32)
    den[::5] = rng.normal(size=len(den[::5]))
    den.view(np.int32)[3::7] = rng.integers(1, 1 << 23, size=len(den[3::7]))
    ones = base.copy()
    ones.view(np.int32)[n - n // 3] = 0x7FFFFFFF
    return {"normal": base, "ties": ties, "nan_inf": nan, "denormals": den,
            "all_ones_nan": ones}


CASES = ("normal", "ties", "nan_inf", "denormals", "all_ones_nan")
# (chunk, valid, n_lanes): several chunks and a ragged last one; one chunk
# (the staged tier); padding past the block's lanes, over a chunk and more
CHUNK_LAYOUTS = {"ragged": (1024, 5 * 1024 + 517, 5 * 1024 + 517),
                 "single": (8192, 5 * 1024 + 517, 5 * 1024 + 517),
                 "padded": (1024, 3 * 1024 + 9, 5 * 1024 + 100),
                 "card_chunk": (CHUNK, 2 * CHUNK + 4097, 3 * CHUNK)}


@pytest.mark.parametrize("layout", list(CHUNK_LAYOUTS))
@pytest.mark.parametrize("case", CASES)
def test_chunked_model_keeps_the_plain_mask(case, layout):
    chunk, valid, n_lanes = CHUNK_LAYOUTS[layout]
    x = torch.from_numpy(_cases(valid, len(case) + chunk)[case])
    for k in (1, 2, 17, chunk - 1, chunk, chunk + 1, n_lanes // 3,
              n_lanes // 2 + 1, n_lanes - 1, n_lanes, 0, -4):
        got = _chunked_keep(x, valid, n_lanes, k, chunk)
        want = _plain_keep(x, valid, n_lanes, k)
        assert torch.equal(got, want), (case, layout, k)


@pytest.mark.parametrize("chunk", [1024, CHUNK])
def test_chunked_model_ranks_ties_across_a_chunk_edge(chunk):
    """A run of the threshold's value over a chunk edge, cut inside the
    next chunk (and at the edge itself); the same run at exponent 0
    (zeros and denormals, the threshold 0.0 with room for some)."""
    rng = np.random.default_rng(chunk)
    n = 3 * chunk + 77
    x = (rng.normal(size=n) * 1e-3).astype(np.float32)
    x[chunk - 300:chunk + 300] = 1.0
    x[::97] = 2.0
    n_two = len(x[::97][x[::97] == 2.0])
    zero = x.copy()
    zero[chunk - 300:chunk + 300] = 0.0
    zero.view(np.int32)[chunk + 7:chunk + 200:3] = 5
    for vec, above in ((x, n_two), (zero, n - 600 + len(range(chunk + 7, chunk + 200, 3)))):
        t = torch.from_numpy(vec)
        for k in (above + 1, above + 299, above + 300, above + 301, above + 550):
            for valid, n_lanes in ((n, n), (n - 10, n + chunk)):
                got = _chunked_keep(t, valid, n_lanes, k, chunk)
                assert torch.equal(got, _plain_keep(t, valid, n_lanes, k)), (k, valid)


def _seg(w: int) -> int:
    """narrow_seg: the segment of a block of 32 lanes or fewer."""
    return 32 if w > 16 else 16 if w > 8 else 8 if w > 4 else 4 if w > 2 else w


def _bpw(w: int) -> int:
    """narrow_bpw: blocks a warp of the narrow tier."""
    return WARP_SPAN // _seg(w) if w <= 32 else WARP_SPAN // w


def _kth_by_ranks(bits: torch.Tensor, counted: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """A segment's k-th largest pattern as ``narrow_segments`` finds it:
    the pattern of the counted lane that k - 1 counted lanes precede
    (larger patterns, or equal ones at a lower lane), each lane counting
    its predecessors."""
    n = bits.shape[-1]
    b_i, b_j = bits[..., :, None], bits[..., None, :]
    lower = torch.arange(n)[None, :] < torch.arange(n)[:, None]        # j < i
    before = (counted[..., None, :] & ((b_j > b_i) | ((b_j == b_i) & lower))).sum(-1)
    hit = counted & (before == (k[..., None] - 1))
    return torch.where(hit, bits, 0).sum(-1)                            # one hit


def _kth_by_bisection(bits: torch.Tensor, counted: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """A block's k-th largest pattern as ``narrow_rows`` finds it: lo = 0,
    hi = max + 1, halved while hi - lo > 1, each count a warp reduction."""
    lo = torch.zeros_like(k)
    hi = torch.where(counted, bits, 0).amax(-1) + 1
    while bool((hi - lo > 1).any()):
        mid = lo + (hi - lo) // 2
        cnt = ((bits >= mid[..., None]) & counted).sum(-1)
        go = hi - lo > 1
        lo = torch.where(go & (cnt >= k), mid, lo)
        hi = torch.where(go & (cnt < k), mid, hi)
    return lo


def _narrow_keep(x: torch.Tensor, w: int, ks: torch.Tensor) -> torch.Tensor:
    """``narrow_blocks``' keep mask for the blocks of w < 256 lanes tiling
    x (the last ragged), ks a k per block: at 32 lanes or fewer the blocks
    side by side in segments of ``_seg(w)`` lanes of 32-lane warp rows (the
    lanes past w not counted), the k-th pattern by ranks; else a block over
    ceil(w / 32) rows of 32, by bisection. The all-ones NaN gives the
    threshold 0.0 and k <= 0 keeps nothing (the closed forms); then the
    float tests, and ties in (row, lane) order by popcounts below the lane.
    A block with k >= w keeps every lane but a NaN."""
    n = x.numel()
    nb = -(-n // w)
    bits = torch.nn.functional.pad(x.view(torch.int32) & 0x7FFFFFFF,
                                   (0, nb * w - n)).long().view(nb, w)
    lanes = _seg(w) if w <= 32 else 32 * -(-w // 32)
    lay = torch.nn.functional.pad(bits, (0, lanes - w))
    counted = (torch.arange(lanes) < w).expand(nb, lanes)
    k = ks.long()
    kth = (_kth_by_ranks if w <= 32 else _kth_by_bisection)(lay, counted, k)
    wrapped = ((lay == 0x7FFFFFFF) & counted).any(-1)
    t = torch.where(wrapped, 0, torch.where(k <= 0, 0x7F800000, kth))[:, None]
    thresh, mag = _daz_float(t), _daz_float(lay)
    gt, eq = counted & (mag > thresh), counted & (mag == thresh)
    n_gt = gt.sum(-1, keepdim=True)
    rank = torch.cumsum(eq.int(), -1)           # popc(ties & below) + 1, carried
    keep = gt | (eq & (rank <= k[:, None] - n_gt))
    keep = torch.where(k[:, None] >= w, lay <= 0x7F800000, keep)[:, :w]
    return keep.reshape(-1)[:n]


def _narrow_spans(n_rows: int, d: int, w: int) -> list:
    """The narrow tier's CTA spans [start, end) over an [n_rows, d] matrix:
    blocks g0 .. g0 + 8 * _bpw(w) of ``RowsGeo``."""
    nb = -(-d // w)
    n_blocks, per_cta = n_rows * nb, 8 * _bpw(w)

    def geo(g):
        row, col = divmod(g, nb)
        return row * d + col * w, min(w, d - col * w)

    spans = []
    for g0 in range(0, n_blocks, per_cta):
        first, (last_s, last_v) = geo(g0)[0], geo(min(g0 + per_cta, n_blocks) - 1)
        spans.append((first, last_s + last_v))
    return spans


NARROW_WIDTHS = (1, 2, 3, 16, 17, 31, 32, 33, 100, 128, 255)


@pytest.mark.parametrize("w", NARROW_WIDTHS)
@pytest.mark.parametrize("case", CASES)
def test_narrow_model_keeps_the_plain_mask(case, w):
    n = 37 * w + w // 2 + 1                     # a ragged last block
    x = torch.from_numpy(_cases(n, w)[case])
    nb = -(-n // w)
    rng = np.random.default_rng(w)
    # literal ks (the rows entry's: 0 and below, past w) and clipped ones
    for ks in (rng.integers(-3, w + 4, size=nb), np.clip(rng.integers(-3, w + 4, size=nb), 1, w),
               np.full(nb, max(1, w // 3)), np.zeros(nb, np.int64)):
        ks = torch.from_numpy(ks.astype(np.int32))
        got = _narrow_keep(x, w, ks)
        rows = torch.nn.functional.pad(x, (0, nb * w - n)).view(nb, w)
        want = topk_threshold_mask(rows, ks[:, None]).reshape(-1)[:n]
        assert torch.equal(got, want), (case, w)


@pytest.mark.parametrize("w", NARROW_WIDTHS)
def test_narrow_spans_tile_the_matrix(w):
    """A CTA's blocks are one contiguous span of at most 4,096 lanes, and
    the spans cover the matrix once, ragged rows included."""
    for n_rows, d in ((3, 1000), (50, 2 * w + 1), (7, 5)):
        spans = _narrow_spans(n_rows, d, w)
        assert spans[0][0] == 0 and spans[-1][1] == n_rows * d
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert max(e - s for s, e in spans) <= 4096
