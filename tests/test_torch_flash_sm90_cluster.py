"""The bf16/fp16 tensor-core flash kernel's thread-block cluster (ROADMAP
B-8i), modelled on the CPU.

From a padded head dim of 321 to 1,792 (``ops.sm90_route``:
``"sm90_cluster"``) the column groups of a query tile run as one cluster
(``csrc/flash_sm90.cuh``: ``flash_fwd_sm90_cluster``): each group's CTA
computes the partial scores over its own columns, and every CTA adds the
NG partials in the order g = 0, 1, ... . Two groups of 160 (D up to 320)
stay on the wide kernel, and more than 8 groups (D past 1,792) take the
split route (``test_torch_flash_split.py``). Here, on the CPU:

* the routes, the reach ``SM90_CLUSTER_MAX`` and the per-route launch
  counters on each side of 256, 320 and the reach;
* ``tests/torch_flash_models.sm90_model`` (each group's partial a chain of
  16-column k-steps, the partials added in group order; the wide kernel's
  64-column chunks at 264) and, one step past the reach,
  ``split_model``: every group's running max and sum equal bit for bit,
  and the output within the card's 16-bit gate, 2e-2, of softmax attention
  in float64 and of the plain version, at D = 264, 512, the reach and one
  step past it, with a window and Skv != Sq.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import attention_ref, flash_attention, ops
from torch_flash_models import sm90_model, split_model

GATE = 2e-2          # chip_smoke.FLASH_ATOL in bf16 and fp16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, Sq, H, KV, D, Skv, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
            for s in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D))]


def _attention_f64(q, k, v, *, causal, window):
    """Softmax attention of q, k, v in float64, masked scores -1e30 (a row
    with no visible key is the mean of V, as in the plain version)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qd = q.double().transpose(1, 2)
    kd, vd = (t.double().transpose(1, 2).repeat_interleave(H // KV, dim=1)
              for t in (k, v))
    s = qd @ kd.transpose(-1, -2) / D ** 0.5
    rows, keys = torch.arange(Sq)[:, None], torch.arange(Skv)[None, :]
    vis = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        vis &= keys <= rows
    if window:
        vis &= rows - keys < window
    s = torch.where(vis, s, -1e30)
    return (torch.softmax(s, dim=-1) @ vd).transpose(1, 2)


def test_routes_reach_and_counters():
    """bf16/fp16 head dims (padded to 8) take one CTA a query tile to 256,
    the wide kernel for two groups of 160 (to 320), the cluster to 1,792 (8
    groups of 224, the portable cluster size) and the split route above; a
    CPU call counts no launch on any route."""
    route = {D: ops.sm90_route(D) for D in (8, 256, 264, 320, 328, 512, 1792, 1800)}
    assert route == {8: "sm90", 256: "sm90", 264: "sm90_wide", 320: "sm90_wide",
                     328: "sm90_cluster", 512: "sm90_cluster", 1792: "sm90_cluster",
                     1800: "sm90_split"}
    assert ops.SM90_CLUSTER_MAX == 8 * ops.GROUP_MAX[torch.bfloat16] == 1792
    assert ops.SM90_WIDE_PAIR_MAX == 2 * 160
    for dt in (torch.bfloat16, torch.float16):
        assert ops.column_groups(320, dt) == (2, 160)
        assert ops.column_groups(328, dt) == (2, 192)
        assert ops.column_groups(1792, dt) == (8, 224)
        assert ops.column_groups(1800, dt) == (9, 224)
        assert ops.query_tile_rows(dt, 1792) == ops.query_tile_rows(dt, 1800) == 128
    assert set(ops.SM90_ROUTE_COUNTERS) == {"sm90", "sm90_cluster", "sm90_wide",
                                            "sm90_split"}
    fa = ops.flash_attention
    names = ["launches", "launches_bf16", "launches_f16",
             *ops.SM90_ROUTE_COUNTERS.values()]
    assert all(isinstance(getattr(fa, n), int) for n in ops.SM90_ROUTE_COUNTERS.values())
    before = {n: getattr(fa, n) for n in names}
    for dt in (torch.bfloat16, torch.float16):
        for D in (200, 264, 512, 1800):
            q, k, v = _inputs(D, 1, 40, 2, 1, D, 40, dt)
            assert flash_attention(q, k, v, causal=True).shape == q.shape
    assert {n: getattr(fa, n) for n in names} == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cluster_groups_hold_the_same_max_and_sum(dtype):
    """Every column group of a query tile adds the partials in the same
    order: each warpgroup's running max and sum are equal, bit for bit,
    across the 5 groups of D = 1,000 (a window, ragged tiles, and rows with
    no visible key)."""
    q, k, v = _inputs(9, 1, 200, 2, 1, 1000, 77, dtype)
    assert ops.sm90_route(1000) == "sm90_cluster"
    record = []
    sm90_model(q, k, v, causal=False, window=50, record=record)
    ng = ops.column_groups(1000, dtype)[0]
    assert ng == 5 and {r[0] for r in record} == set(range(ng))
    by_tile = {}
    for g, q0, r_lo, m, l in record:
        by_tile.setdefault((q0, r_lo), []).append((m, l))
    assert len(by_tile) == 4
    for stats in by_tile.values():
        assert len(stats) == ng
        for m, l in stats[1:]:
            assert torch.equal(m, stats[0][0]) and torch.equal(l, stats[0][1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [264, 512, 1792, 1800])
def test_model_fits_the_16_bit_gate_of_float64(dtype, D):
    """The modelled kernel (the cluster at 512 and 1,792, the wide kernel at
    264, the split route at 1,800) within 2e-2 of softmax attention in
    float64 and of the plain version: causal, a window of 40, Skv = 150 !=
    Sq = 130."""
    q, k, v = _inputs(D, 1, 130, 2, 1, D, 150, dtype)
    if ops.sm90_route(D) == "sm90_split":
        got = split_model(q, k, v, causal=True, window=40)[0]
    else:
        got = sm90_model(q, k, v, causal=True, window=40)
    assert got.dtype == dtype and got.shape == q.shape
    exact = _attention_f64(q, k, v, causal=True, window=40)
    np.testing.assert_allclose(got.double().numpy(), exact.numpy(), atol=GATE, rtol=0)
    want = attention_ref(q, k, v, causal=True, window=40)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=GATE,
                               rtol=0)
