"""The fp32 flash kernel on the tensor cores in 3xTF32 (ROADMAP B-8f),
modelled on the CPU against the plain version and the JAX package.

Head dims 129 to 2,048 in fp32 run ``csrc/flash_tf32.cuh``: each fp32
operand split into two TF32 parts, three products on mma.sync, up to 256
one CTA a 128-row query tile, above it the column groups of O one
thread-block cluster that sums the groups' partial scores once. Here, on
the CPU, ``tests/torch_flash_models.tf32_model`` repeats that arithmetic
(the split, each mma's exact sum rounded toward zero as the tensor core
rounds it, a score's chain a 32-column box, the partials added in the
order g = 0, 1, ..., the softmax's shares) and is held:

* at the head dims of the fp32 ``FLASH_CASES`` from 160 to 256 and of
  ``WIDE_DIMS`` (264 to 1,024) of ``chip_smoke.py``, S, batch and heads
  cut, unit-variance inputs, against the plain version (out and lse) and
  the interpreted Pallas kernel, within the card's fp32 gate, 1e-5;
* with every column group's running max and sum equal, bit for bit;
* against one long chain a score: the 32-column boxes keep the output
  nearer softmax attention in float64 (the card's rounding toward zero
  drifts along a chain);
* and the wrapper's fp32 routes, tiles and counters.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro_torch.kernels.flash_attention import attention_ref, flash_attention, ops
from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
from torch_flash_models import round_to_zero, tf32_model, tf32_split

GATE = 1e-5          # chip_smoke.FLASH_ATOL and FLASH_LSE_ATOL in fp32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, Sq, H, KV, D, Skv=None):
    rng = np.random.default_rng(seed)
    Skv = Skv or Sq
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D))]


@pytest.mark.parametrize("B,S,H,KV,D,causal,window,Skv", [
    # chip_smoke's fp32 FLASH_CASES at 160 to 256, cut
    (1, 250, 2, 1, 160, True, 100, None),
    (1, 200, 2, 2, 192, False, None, 150),
    (1, 200, 2, 1, 224, True, 64, None),
    (1, 256, 2, 1, 256, True, None, None),       # Gemma's head dim
    # WIDE_DIMS, at WIDE_CASES' three calls in turn, cut
    (1, 160, 2, 1, 264, True, None, None),
    (1, 150, 2, 2, 288, True, 40, None),
    (1, 140, 2, 1, 300, False, None, 100),
    (1, 160, 2, 1, 320, True, None, None),
    (1, 150, 2, 2, 384, True, 40, None),
    (1, 140, 2, 1, 512, False, None, 100),
    (1, 130, 1, 1, 1024, True, None, None),
])
def test_tf32_model_fits_the_fp32_gate(B, S, H, KV, D, causal, window, Skv):
    q, k, v = _inputs(D, B, S, H, KV, D, Skv)
    record = []
    got, lse = tf32_model(q, k, v, causal=causal, window=window, record=record)
    want = attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=GATE, rtol=0)
    _, lse_want = flash_fwd_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(lse.numpy(), lse_want.numpy(), atol=GATE, rtol=0)
    with jax.threefry_partitionable(False):
        pallas = flash_attention_pallas(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                        causal=causal, window=window, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=GATE, rtol=0)
    # every group of a query tile holds the same m and l, bit for bit
    ng = ops.column_groups(-(-D // 4) * 4, torch.float32)[0]
    assert {r[0] for r in record} == set(range(ng))
    for q0 in {r[1] for r in record}:
        stats = [(m, l) for g, t0, m, l in record if t0 == q0]
        assert len(stats) == ng
        for m, l in stats[1:]:
            assert torch.equal(m, stats[0][0]) and torch.equal(l, stats[0][1])


def test_32_column_chains_stay_nearer_float64():
    """One chain of mma a score, each rounded toward zero, drifts with D;
    a fresh accumulator every 32 columns, the boxes added in float32, holds
    the output near softmax attention in float64 (the card: 5.8e-6 with one
    chain at D = 256, 2-3e-6 with boxes)."""
    q, k, v = _inputs(7, 1, 130, 2, 1, 256)
    s = torch.einsum("bqhd,bkd->bhqk", q.double(), k[:, :, 0].double()) / 16
    s = s.masked_fill(torch.ones(130, 130, dtype=torch.bool).triu(1), -math.inf)
    exact = torch.einsum("bhqk,bkd->bqhd", torch.softmax(s, -1), v[:, :, 0].double())
    boxed, _ = tf32_model(q, k, v, causal=True, window=None)
    chain, _ = tf32_model(q, k, v, causal=True, window=None, box=None)
    far_boxed = float((boxed.double() - exact).abs().max())
    far_chain = float((chain.double() - exact).abs().max())
    assert far_boxed < 0.5 * far_chain
    assert far_boxed < 4e-6


def test_tf32_split_and_round_to_zero():
    """hi + lo is x exactly, hi a TF32 pattern (low 13 bits clear); lo as
    the tensor core reads it loses under 2^-21 of |x|; rounding toward
    zero never moves away from zero and lands within an ulp."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.standard_normal(10_000) * 10.0 ** rng.integers(-30, 30, 10_000))
                         .astype(np.float32))
    hi, lo = tf32_split(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    exact_lo = x - hi
    assert torch.equal((hi.double() + exact_lo.double()).float(), x)
    assert bool(((exact_lo - lo).abs() <= x.abs() * 2.0 ** -21).all())
    y = torch.from_numpy(rng.standard_normal(10_000) * 1e3)
    r = round_to_zero(y)
    assert bool((r.double().abs() <= y.abs()).all())
    assert bool(((y - r.double()).abs() <= torch.finfo(torch.float32).eps * y.abs()).all())


def test_fp32_routes_tiles_and_counters():
    """fp32 head dims (padded to 4) take the SIMT kernel to 128, the 3xTF32
    kernel to 256 (128-row tiles, one group), its clusters to 2,048 (at
    most 8 groups of 256) and the split route above (128-row tiles:
    test_torch_flash_split.py); a CPU call counts no launch on any route."""
    route = {D: ops.f32_route(D) for D in (4, 128, 132, 256, 260, 2048, 2052)}
    assert route == {4: "simt", 128: "simt", 132: "tf32", 256: "tf32",
                     260: "tf32_cluster", 2048: "tf32_cluster", 2052: "tf32_split"}
    rows = {D: ops.query_tile_rows(torch.float32, D) for D in route}
    assert rows == {4: 64, 128: 64, 132: 128, 256: 128, 260: 128, 2048: 128,
                    2052: 128}
    assert ops.column_groups(2048, torch.float32) == (8, 256)
    assert ops.column_groups(2052, torch.float32)[0] == 9
    assert ops.column_groups(260, torch.float32) == (2, 160)
    ops.check_grid(1, 1, 65535 * 128, 256, torch.float32)
    with pytest.raises(ValueError):
        ops.check_grid(1, 1, 65535 * 128 + 1, 256, torch.float32)
    ops.check_grid(1, 1, 65535 * 128, 2052, torch.float32)
    with pytest.raises(ValueError):
        ops.check_grid(1, 1, 65535 * 128 + 1, 2052, torch.float32)
    fa = ops.flash_attention
    names = ["launches", "launches_f32", *ops.F32_ROUTE_COUNTERS.values()]
    before = {n: getattr(fa, n) for n in names}
    q, k, v = _inputs(3, 1, 64, 2, 1, 160)
    flash_attention(q, k, v, causal=True)
    assert {n: getattr(fa, n) for n in names} == before
