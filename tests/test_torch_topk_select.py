"""The block top-k kernels' select (``csrc/topk_common.cuh``), modelled in
plain PyTorch and held bit for bit against the port's
``topk_threshold_mask`` and the JAX package's.

The CUDA kernels cannot run here, so ``kernel_mask`` repeats what a CTA
computes, step for step: the lane layout (thread t of 256 holds lanes
t + 256 p, p < 16), the radix select's 4 passes over digits of 8, 8, 8 and 7 bits of
the 31-bit pattern of |x| (one histogram a pass, its scan of the bins from
the top as warp scans plus warp totals, the winning bin and the rank left
in it), the wrapped 31-pass bisection of a block
whose largest pattern is 0x7fffffff, the float tests (denormals compare
as zero, as on XLA's CPU: ROADMAP C-16), and the tie scan in
index order through (p, warp, lane) ballots and the exclusive scan of the
128 (p, warp) counts. Both kernels, the rows one and the one-vector one,
run this select in CTAs of that shape. ``chip_smoke.py`` holds the kernels themselves to the port's plain version
on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.topk_sparsify.ref import topk_threshold_mask as j_mask

from repro_torch.kernels.topk_sparsify.ref import topk_threshold_mask

MAX_BLOCK = 4096
PASSES = ((23, 8), (15, 8), (7, 8), (0, 7))     # (shift, bits), top digit first
BINS = 256
THREADS = 256                                   # a CTA; 16 lanes a thread
INT_MIN = -2 ** 31


def _wrap(v: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32, as the kernel's int arithmetic."""
    return ((v + 2 ** 31) % 2 ** 32) - 2 ** 31


def _warp_scan_from_top(cnt: torch.Tensor) -> torch.Tensor:
    """The bin scan: thread t < 256 owns bin nb - 1 - t; a warp inclusive
    scan plus the totals of the warps before. cnt [R, nb] -> inclusive
    counts from the top, per bin."""
    r, nb = cnt.shape
    by_thread = torch.zeros(r, BINS, dtype=torch.int64)
    by_thread[:, :nb] = cnt.flip(1)
    warps = by_thread.view(r, BINS // 32, 32).cumsum(-1)
    before = torch.cumsum(warps[:, :, -1], 1) - warps[:, :, -1]
    incl = (warps + before[:, :, None]).reshape(r, BINS)[:, :nb]
    return incl.flip(1)


def _radix_threshold(bits, counted, k):
    """4 passes: prefix of the threshold's digits, kk its rank among the
    lanes that share them. bits, counted [R, 4096] in lane order."""
    r = bits.shape[0]
    prefix = torch.zeros(r, dtype=torch.int64)
    kk = k.clone()
    for shift, width in PASSES:
        nb = 1 << width
        in_play = counted & ((bits >> (shift + width)) == prefix[:, None])
        digit = (bits >> shift) & (nb - 1)
        cnt = torch.zeros(r, nb, dtype=torch.int64)
        cnt.scatter_add_(1, digit, in_play.long())
        incl = _warp_scan_from_top(cnt)
        excl = incl - cnt
        win = (excl < kk[:, None]) & (kk[:, None] <= incl)
        assert bool((win.sum(1) == 1).all())
        d = win.long().argmax(1)
        prefix = (prefix << width) | d
        kk = kk - excl.gather(1, d[:, None])[:, 0]
    return prefix


def _wrapped_bisection(bits, counted, k):
    """The reference's bisection with hi = max(bits) + 1 = INT_MIN."""
    lo = torch.zeros(bits.shape[0], dtype=torch.int64)
    hi = torch.full_like(lo, INT_MIN)
    for _ in range(31):
        mid = _wrap(lo + (_wrap(hi - lo) >> 1))
        enough = (counted & (bits >= mid[:, None])).sum(1) >= k
        lo, hi = torch.where(enough, mid, lo), torch.where(enough, hi, mid)
    return lo


def _compared(bits: torch.Tensor, daz: bool) -> torch.Tensor:
    """The float32 a compare sees for int64 patterns: denormals as +0.0
    when ``daz`` (the kernels' ``daz_float``), else the IEEE value."""
    if daz:
        bits = torch.where((bits & 0x7F800000) == 0, 0, bits)
    return _wrap(bits).to(torch.int32).view(torch.float32)


def kernel_mask(x: torch.Tensor, k, *, valid=None, daz=True) -> torch.Tensor:
    """What a CTA keeps of each row of ``x`` [R, n]
    (n <= 4096 lanes counted; the lanes of [valid, n) hold the ragged
    tail's zeros) at ``k`` (an int or [R]). Returns the mask [R, n].
    ``daz=False`` makes the float tests IEEE compares instead."""
    r, n = x.shape
    per = MAX_BLOCK // THREADS
    valid = n if valid is None else valid
    k = torch.clamp(torch.as_tensor(k, dtype=torch.int64).expand(r), min=1)
    raw = torch.zeros(r, MAX_BLOCK, dtype=torch.int64)
    raw[:, :valid] = x[:, :valid].to(torch.float32).view(torch.int32).long()
    bits = raw & 0x7FFFFFFF
    lanes = torch.arange(MAX_BLOCK)
    counted = (lanes < n)[None, :].expand(r, MAX_BLOCK)
    full = k >= n                               # the kernel's all-but-NaN branch
    k = torch.where(full, n - 1, k)

    wrapped = ((bits == 0x7FFFFFFF) & counted).any(1)
    thresh = torch.where(wrapped, _wrapped_bisection(bits, counted, k),
                         _radix_threshold(bits, counted, k))
    t32 = _compared(thresh, daz)[:, None]
    mag = _compared(bits, daz)
    gt = counted & (mag > t32)
    eq = counted & (mag == t32)

    # ties in index order: lane e = p * 256 + warp * 32 + lane
    w = THREADS // 32
    eq4 = eq.view(r, per, w, 32)
    counts = eq4.sum(-1).reshape(r, per * w)                 # (p, warp)
    lane_sums = counts.view(r, 32, 4)                        # 4 entries a lane
    s = lane_sums.sum(-1)
    run = torch.cumsum(s, 1) - s                             # warp 0's scan
    entry = (run[:, :, None] + torch.cumsum(lane_sums, -1) - lane_sums
             ).reshape(r, per, w, 1)
    below = torch.cumsum(eq4.long(), -1) - eq4.long()       # popc below lane
    rank = (entry + below + 1).reshape(r, MAX_BLOCK)
    room = k - gt.sum(1)
    keep = gt | (eq & (rank <= room[:, None]))
    return torch.where(full[:, None], ~(bits > 0x7F800000), keep)[:, :n]


# ---- inputs -----------------------------------------------------------------
def _f32(bits) -> np.ndarray:
    return np.asarray(bits, dtype=np.uint32).view(np.float32)


def _case(name: str, n: int, rng) -> np.ndarray:
    if name == "gradient":          # magnitudes crowd a few exponent bins
        return (rng.normal(size=n) * 1e-3).astype(np.float32)
    if name == "ties_across_digits":
        # patterns that share the exponent and some mantissa digits: ties
        # of the k-th value, neighbours one ulp or one digit away
        base = np.uint32(0x3F800000)
        steps = rng.choice(np.array([0, 1, 0x7F, 0x80, 0x81, 0x7FFF, 0x8000],
                                    dtype=np.uint32), size=n)
        v = _f32(base + steps)
        v[rng.random(n) < 0.5] *= -1
        return v
    if name == "all_equal":
        return np.full(n, -0.375, np.float32)
    if name == "all_zero":
        return np.zeros(n, np.float32)
    if name == "specials":
        v = rng.normal(size=n).astype(np.float32)
        v[::17] = np.nan
        v[1::23] = np.inf
        v[2::29] = -np.inf
        v[3::7] = -0.0
        v[4::11] = 0.0
        v[5::13] = 1.25                               # ties
        return v
    if name == "all_ones_nan":      # a NaN with every mantissa bit set
        v = rng.normal(size=n).astype(np.float32)
        v[5] = _f32(0x7FFFFFFF)
        v[9::31] = np.nan
        v[10::37] = np.inf
        return v
    if name == "negative_all_ones_nan":
        v = rng.normal(size=n).astype(np.float32)
        v[n // 2] = _f32(0xFFFFFFFF)
        return v
    if name == "denormal_threshold":   # a mid k's threshold is a denormal
        v = np.zeros(n, np.float32)
        v[::40] = rng.normal(size=len(v[::40]))
        v[3::7] = _denormals(len(v[3::7]), rng)
        return v
    if name == "denormals_after_zeros":  # threshold 0, denormals late
        v = np.zeros(n, np.float32)
        v[:20] = rng.normal(size=20)
        v[n // 2::9] = _denormals(len(v[n // 2::9]), rng)
        return v
    raise KeyError(name)


def _denormals(size: int, rng) -> np.ndarray:
    """float32 denormals of either sign (exponent field 0, mantissa > 0)."""
    bits = rng.integers(1, 1 << 23, size=size, dtype=np.uint32)
    bits[rng.random(size) < 0.5] |= np.uint32(0x80000000)
    return _f32(bits)


CASES = ("gradient", "ties_across_digits", "all_equal", "all_zero",
         "specials", "all_ones_nan", "negative_all_ones_nan",
         "denormal_threshold", "denormals_after_zeros")


def _check(x: np.ndarray, ks, *, n_lanes: int, valid: int,
           dtype=torch.float32):
    """x [R, n_lanes] with zeros past ``valid`` (the reference's padding):
    the model against the port's and the JAX package's masks."""
    xt = torch.from_numpy(x).to(dtype)
    kt = torch.as_tensor(ks, dtype=torch.int32)[:, None]
    got = kernel_mask(xt, kt[:, 0].long(), valid=valid)
    want = topk_threshold_mask(xt, torch.clamp(kt, 1, n_lanes))
    assert torch.equal(got, want)
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx = jnp.asarray(x).astype(jd)
    jwant = np.asarray(j_mask(jx, jnp.clip(jnp.asarray(kt.numpy()), 1, n_lanes)))
    np.testing.assert_array_equal(got.numpy(), jwant)
    return got


@pytest.mark.parametrize("ks", [(1, 2, MAX_BLOCK - 1, 409, 2048, MAX_BLOCK),
                                (3, 17, 1024, 3000, 4000, 4095)])
@pytest.mark.parametrize("case", CASES)
def test_model_equals_the_masks_at_4096_lanes(ks, case):
    rng = np.random.default_rng(CASES.index(case))
    x = np.stack([_case(case, MAX_BLOCK, rng) for _ in range(6)])
    got = _check(x, list(ks), n_lanes=MAX_BLOCK, valid=MAX_BLOCK)
    if case not in ("all_ones_nan",):
        finite = ~torch.isnan(torch.from_numpy(x)).any(1)
        counts = got.sum(1)
        assert bool((counts[finite] == torch.tensor(ks)[finite]).all())


@pytest.mark.parametrize("ks", [(1, 100, MAX_BLOCK - 1), (2, 2048, 4000)])
def test_the_all_ones_nan_keeps_the_references_wrapped_mask(ks):
    """max(bits) = 0x7fffffff: the reference's max + 1 wraps and its
    bisection keeps every non-NaN lane, more than k; the kernel's branch
    keeps the same lanes."""
    rng = np.random.default_rng(11)
    x = np.stack([_case("all_ones_nan", MAX_BLOCK, rng) for _ in range(3)])
    got = _check(x, list(ks), n_lanes=MAX_BLOCK, valid=MAX_BLOCK)
    want = ~torch.isnan(torch.from_numpy(x))
    assert torch.equal(got, want)


def test_zeros_beside_the_all_ones_nan_follow_ieee_compares():
    """In a wrapped block the threshold is the pattern 0x80000001, a
    negative denormal. IEEE compares (the model with ``daz=False``) would
    keep the zero lanes beside it; XLA on the CPU compares the denormal as
    0.0, so the JAX package's mask drops them as ties that do not fit, and
    so do the port's plain version and the kernels' model, which compare
    denormals as zero (ROADMAP C-16). Every lane agrees with the reference;
    the zero lanes are the only ones the IEEE compares would keep."""
    rng = np.random.default_rng(5)
    x = np.stack([_case("all_ones_nan", MAX_BLOCK, rng) for _ in range(2)])
    x[:, 3::5] = -0.0
    x[1, 4::9] = 0.0
    xt = torch.from_numpy(x)
    ks = torch.tensor([[100], [MAX_BLOCK - 1]])
    got = kernel_mask(xt, ks[:, 0])
    assert torch.equal(got, topk_threshold_mask(xt, ks))
    jwant = np.asarray(j_mask(jnp.asarray(x), jnp.asarray(ks.numpy())))
    np.testing.assert_array_equal(got.numpy(), jwant)
    # at k = 100 no tie fits: every zero is dropped (at k = 4095 they fit)
    assert torch.equal(got[0], ~torch.isnan(xt[0]) & (xt[0] != 0))
    ieee = kernel_mask(xt, ks[:, 0], daz=False)
    assert torch.equal(ieee, ~torch.isnan(xt))
    differ = ieee.numpy() != jwant
    assert differ.any() and (x[differ] == 0).all() and not jwant[differ].any()


@pytest.mark.parametrize("k", [100, 409, 700])
def test_a_denormal_threshold_ties_with_zero_as_in_the_reference(k):
    """C-16 (b): the k-th largest |x| is a denormal. With denormals as zero
    every denormal and zero lane is a tie of the threshold, filled in index
    order, where IEEE compares would keep the largest denormals; the model,
    the port and the JAX package keep the same lanes."""
    rng = np.random.default_rng(k)
    x = np.stack([_case("denormal_threshold", MAX_BLOCK, rng) for _ in range(3)])
    got = _check(x, [k] * 3, n_lanes=MAX_BLOCK, valid=MAX_BLOCK)
    bits = np.abs(x).view(np.int32)
    assert ((bits[:, ::40] > 0x7FFFFF).sum(1) < k).all()      # normals fit
    ieee = kernel_mask(torch.from_numpy(x), k, daz=False)
    assert not torch.equal(got, ieee)
    assert (got.sum(1) == k).all() and (ieee.sum(1) == k).all()


@pytest.mark.parametrize("k", [409, 2048, 2200])
def test_denormals_after_zeros_are_kept_in_index_order(k):
    """C-16 (c): the threshold is 0.0 and denormal lanes sit after zeros.
    The reference keeps the first ties in index order, zeros and denormals
    alike, so a late denormal is dropped (IEEE compares would keep every
    denormal as larger than zero); the kept ones keep their bits."""
    rng = np.random.default_rng(k)
    x = np.stack([_case("denormals_after_zeros", MAX_BLOCK, rng)
                  for _ in range(2)])
    got = _check(x, [k] * 2, n_lanes=MAX_BLOCK, valid=MAX_BLOCK)
    denormal = (x != 0) & (np.abs(x).view(np.int32) <= 0x7FFFFF)
    lanes = np.arange(MAX_BLOCK)
    np.testing.assert_array_equal(got.numpy()[denormal],
                                  np.broadcast_to(lanes < k, x.shape)[denormal])
    ieee = kernel_mask(torch.from_numpy(x), k, daz=False)
    assert ieee.numpy()[denormal].all()


@pytest.mark.parametrize("valid", [1, 100, 4000, 4095])
@pytest.mark.parametrize("case", ["gradient", "specials", "all_equal"])
def test_model_on_a_ragged_tail(valid, case):
    """The last block of a row: lanes past ``valid`` compete as zeros."""
    rng = np.random.default_rng(valid)
    x = np.stack([_case(case, MAX_BLOCK, rng) for _ in range(4)])
    x[:, valid:] = 0.0
    _check(x, [1, 2, 700, MAX_BLOCK - 1], n_lanes=MAX_BLOCK, valid=valid)


@pytest.mark.parametrize("block", [256, 1024])
@pytest.mark.parametrize("case", ["gradient", "ties_across_digits", "specials",
                                  "all_ones_nan"])
def test_model_on_narrow_blocks_ignores_the_lanes_past_them(block, case):
    """The one-vector kernel at a block narrower than 4096: lanes past the
    block are not counted (the CTA's layout still spans 4096)."""
    rng = np.random.default_rng(block)
    x = np.stack([_case(case, block, rng) for _ in range(5)])
    for k in (1, 2, block - 1, block // 4, block):     # one static k a launch
        got = _check(x, [k] * len(x), n_lanes=block, valid=block)
        assert got.shape == x.shape


@pytest.mark.parametrize("case", ["gradient", "ties_across_digits", "specials",
                                  "all_equal"])
def test_model_on_bf16_inputs(case):
    """A bf16 lane's mask is its exact fp32 widening's: the low 16 bits of
    every pattern are zero, so the last two passes see one bin."""
    rng = np.random.default_rng(7)
    x = np.stack([_case(case, MAX_BLOCK, rng) for _ in range(4)])
    x = torch.from_numpy(x).bfloat16().float().numpy()
    _check(x, [1, 2, MAX_BLOCK - 1, 1024], n_lanes=MAX_BLOCK, valid=MAX_BLOCK,
           dtype=torch.bfloat16)


def test_the_crowded_exponent_digit_holds_the_threshold():
    """Gradient-like rows: the k-th value's exponent bin holds many lanes,
    so the later passes do the work; the model still equals the masks."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(8, MAX_BLOCK)) * 1e-3).astype(np.float32)
    bits = torch.from_numpy(x).view(torch.int32) & 0x7FFFFFFF
    expo = bits >> 23
    ks = [410, 1024, 1229, 1500, 1800, 2048, 2458, 3277]
    for r, k in enumerate(ks):
        kth = torch.sort(bits[r], descending=True).values[k - 1]
        assert int((expo[r] == (kth >> 23)).sum()) > 400
    _check(x, ks, n_lanes=MAX_BLOCK, valid=MAX_BLOCK)
