"""The flash kernels' split route past the clusters' reach (ROADMAP B-8j),
modelled on the CPU against float64 attention and the JAX package.

fp32 past D = 2,048 and bf16 and fp16 past 1,792 run ``csrc/flash_split.cuh``
(``ops.flash_attention_split_cuda``): a scores kernel computes S = Q K^T
once on the tensor cores, scaled and masked, into a workspace with each
row's maximum a key tile; a P V kernel a column group reads them back, m
the maximum of the tile maxima, no online rescale. A call runs in pieces of
at most ``ops.SPLIT_WORKSPACE_BYTES`` of scores (``ops.split_pieces``).
Here, on the CPU:

* ``tests/torch_flash_models.split_model`` (16-bit S in 64-column chunks,
  fp32 S in 3xTF32 boxes with each mma rounded toward zero, hi rounded to
  nearest and the boxes added with their compensation, m from the tile
  maxima, l in key order, P rounded in 16 bits, group 0's lse) within the
  card's gates (fp32 1e-5, bf16 and fp16 2e-2; lse 1e-5 / 1e-2) of softmax
  attention in float64, of the JAX package's oracle and of the plain
  version's lse, at D = 2,056 and 4,104 (fp32), 1,800 and 3,600 (16 bits),
  in four calls: causal GQA, a window with a ragged query tile, cross
  attention (Skv != Sq, non-causal), rows that see no key; every group's m
  and l equal, bit for bit; the fp32 scores under half as far from float64
  as the 3xTF32 cluster kernels' scheme at D = 4,104;
* the plain versions against the interpreted Pallas kernel at D = 1,800
  (bf16) and 2,056 (fp32), 128 rows;
* the routes at each boundary and their counters, and the pieces: each
  (batch, head, query row) in exactly one, each within the workspace, at
  the timed shape [4, 2048, 32 | 4] (two pieces), at one head of 32,768 x
  32,768, and at 128 heads of it (a (batch, head) cut), counted without
  allocating any.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro_torch.kernels.flash_attention import flash_attention, ops
from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
from torch_flash_models import _split_scores_f32, split_model, tf32_split, tf32_split_rn

GATE = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-2}
LSE_GATE = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-2}
# (B, Sq, H, KV, causal, window, Skv): the causal calls in two query
# tiles, the second ragged (4 rows; under the window its key range starts
# past 0); two shapes, so the JAX oracle compiles twice a type and head dim
CASES = {"causal_gqa": (1, 132, 2, 1, True, None, None),
         "window_ragged": (1, 132, 2, 1, True, 24, None),
         "cross": (1, 72, 2, 1, False, None, 40),
         "no_key_rows": (1, 72, 2, 1, False, 16, 40)}      # rows 55.. see none


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, Sq, H, KV, D, Skv, dtype, scale=1.0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32)).to(dtype)
            for s in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D))]


def _attention_f64(q, k, v, *, causal, window):
    """Softmax attention in float64, masked scores -1e30 (a row with no
    visible key is the mean of V)."""
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


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype,D", [(torch.float32, 2056), (torch.float32, 4104),
                                     (torch.bfloat16, 1800), (torch.bfloat16, 3600),
                                     (torch.float16, 1800), (torch.float16, 3600)])
def test_split_model_fits_the_gates(dtype, D, case):
    """The modelled split route within the card's gates of float64
    attention, the JAX oracle and the plain version's lse; every column
    group's m and l equal, bit for bit."""
    B, S, H, KV, causal, window, Skv = CASES[case]
    Skv = Skv or S
    q, k, v = _inputs(D + len(case), B, S, H, KV, D, Skv, dtype)
    Dp = -(-D // ops.ROW_MULTIPLE[dtype]) * ops.ROW_MULTIPLE[dtype]
    assert ops.route_of(dtype, Dp).endswith("split")
    record = []
    got, lse = split_model(q, k, v, causal=causal, window=window, record=record)
    assert got.dtype == dtype and got.shape == q.shape
    exact = _attention_f64(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.double().numpy(), exact.numpy(), atol=GATE[dtype],
                               rtol=0)
    oracle = j_attention_ref(*(jnp.asarray(t.float().numpy()).astype(str(dtype)[6:])
                               for t in (q, k, v)), causal=causal, window=window)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(oracle, np.float32),
                               atol=GATE[dtype], rtol=0)
    _, lse_want = flash_fwd_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(lse.numpy(), lse_want.numpy(), atol=LSE_GATE[dtype],
                               rtol=0)
    ng = ops.column_groups(Dp, dtype)[0]
    assert ng >= 9 and {r[0] for r in record} == set(range(ng))
    for q0 in {r[1] for r in record}:
        stats = [(m, l) for g, t0, m, l in record if t0 == q0]
        assert len(stats) == ng
        for m, l in stats[1:]:
            assert torch.equal(m, stats[0][0]) and torch.equal(l, stats[0][1])


def test_split_scores_are_nearer_float64():
    """The split route's fp32 scores (hi rounded to nearest, each box's
    chain on the compensation of the boxes' sum) at D = 4,104 against the
    3xTF32 cluster kernels' scheme (hi truncated, fresh chains added in
    float32): under half as far from float64, and within 1.5e-6 (the
    card's tensor core rounds each mma toward zero, so a long sum drifts)."""
    D, W = 4104, 4128
    q, k, _ = _inputs(17, 1, 128, 1, 1, D, 128, torch.float32)
    qs = q[:, :, 0] * torch.tensor(1.0 / D ** 0.5)
    k = k[:, :, 0]
    exact = qs.double() @ k.double().transpose(-1, -2)
    qp, kp = (torch.nn.functional.pad(t, (0, W - D)) for t in (qs, k))
    new = _split_scores_f32(tf32_split_rn(qp), tf32_split_rn(kp), D)
    old = _split_scores_f32(tf32_split(qp), tf32_split(kp), D, compensated=False)
    far_new = float((new.double() - exact).abs().max())
    far_old = float((old.double() - exact).abs().max())
    assert far_new < 0.5 * far_old and far_new < 1.5e-6


@pytest.mark.parametrize("dtype,D,tol", [(torch.bfloat16, 1800, 2e-2),
                                         (torch.float32, 2056, 2e-6)])
def test_plain_versions_match_the_pallas_kernel_past_the_clusters(dtype, D, tol):
    """The interpreted Pallas kernel (causal, a window of 50, 128 rows)
    against the serving plain version and the chunked one under grad (fp32
    2e-6, as the JAX package holds its own kernel; bf16 2e-2)."""
    q, k, v = _inputs(D, 1, 128, 4, 2, D, 128, dtype, scale=0.3)
    with jax.threefry_partitionable(False):
        want = flash_attention_pallas(*(jnp.asarray(t.float().numpy()).astype(str(dtype)[6:])
                                        for t in (q, k, v)),
                                      causal=True, window=50, interpret=True)
    want = np.asarray(want, np.float32)
    got = flash_attention(q, k, v, causal=True, window=50)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
    chunked, _ = flash_fwd_ref(q, k, v, causal=True, window=50)
    np.testing.assert_allclose(chunked.float().numpy(), want, atol=tol, rtol=0)


def test_routes_counters_and_tiles_at_the_boundaries():
    """fp32 past 2,048 and bf16/fp16 past 1,792 take the split route (128-row
    query tiles, the column groups unchanged); the wide kernel keeps 257 to
    320 in 16 bits alone; a CPU call counts nothing on any route."""
    f32 = {D: ops.f32_route(D) for D in (2048, 2052, 4104, 65535 * 224)}
    assert f32 == {2048: "tf32_cluster", 2052: "tf32_split", 4104: "tf32_split",
                   65535 * 224: "tf32_split"}
    s16 = {D: ops.sm90_route(D) for D in (256, 264, 320, 328, 1792, 1800, 3600)}
    assert s16 == {256: "sm90", 264: "sm90_wide", 320: "sm90_wide", 328: "sm90_cluster",
                   1792: "sm90_cluster", 1800: "sm90_split", 3600: "sm90_split"}
    assert [D for D in range(8, 4097, 8) if ops.sm90_route(D) == "sm90_wide"] == \
        list(range(264, 321, 8))
    assert ops.F32_ROUTE_COUNTERS["tf32_split"] == "launches_f32_tf32_split"
    assert ops.SM90_ROUTE_COUNTERS["sm90_split"] == "launches_sm90_split"
    assert "simt_wide" not in ops.F32_ROUTE_COUNTERS
    assert not hasattr(ops.flash_attention, "launches_f32_simt_wide")
    for dt, D in ((torch.float32, 2052), (torch.bfloat16, 1800), (torch.float16, 3600)):
        assert ops.query_tile_rows(dt, D) == 128
    assert ops.column_groups(2056, torch.float32) == (9, 256)
    assert ops.column_groups(4104, torch.float32) == (17, 256)
    assert ops.column_groups(1800, torch.bfloat16) == (9, 224)
    assert ops.column_groups(3600, torch.float16) == (17, 224)
    fa = ops.flash_attention
    names = ["launches", "launches_f32", "launches_bf16", "launches_f16", "split_pieces",
             *ops.F32_ROUTE_COUNTERS.values(), *ops.SM90_ROUTE_COUNTERS.values()]
    before = {n: getattr(fa, n) for n in names}
    for dt, D in ((torch.float32, 2056), (torch.bfloat16, 1800), (torch.float16, 1800)):
        q, k, v = _inputs(5, 1, 40, 2, 1, D, 40, dt)
        assert flash_attention(q, k, v, causal=True).shape == q.shape
    assert {n: getattr(fa, n) for n in names} == before


@pytest.mark.parametrize("B,H,Sq,Skv,n_pieces,bh_cut", [
    (4, 32, 2048, 2048, 2, False),        # the timed shape: 2 GiB of scores
    (1, 1, 32768, 32768, 4, False),       # one head: pieces of 64 query tiles
    (1, 128, 32768, 32768, 512, True),    # 128 heads: 64 (b, h) a piece, a tile
    (3, 5, 1000, 333, 1, False),          # one piece, ragged tiles and keys
])
def test_split_pieces_cover_every_row_once(B, H, Sq, Skv, n_pieces, bh_cut):
    """Each (batch, head, query tile) in exactly one piece, each piece's
    scores within the workspace, whole query tiles of every (batch, head)
    unless one of each does not fit; each piece's grids within CUDA's
    limits (checked by arithmetic, nothing allocated)."""
    pieces = ops.split_pieces(B, H, Sq, Skv)
    assert len(pieces) == n_pieces
    tiles = -(-Sq // ops.SPLIT_ROWS)
    keys = ops.split_keys(Skv)
    assert keys % ops.SPLIT_KEY_PAD == 0 and Skv <= keys < Skv + ops.SPLIT_KEY_PAD
    seen = np.zeros((B * H, tiles), dtype=np.int64)
    for bh0, nbh, t0, nt in pieces:
        assert nbh * nt * ops.SPLIT_ROWS * keys * 4 <= ops.SPLIT_WORKSPACE_BYTES
        assert (nbh < B * H) == bh_cut and (nt == 1 or not bh_cut)
        seen[bh0:bh0 + nbh, t0:t0 + nt] += 1
        for dt in (torch.float32, torch.bfloat16):
            for grid in ops.split_grids((bh0, nbh, t0, nt), Skv, 4104, dt):
                assert 0 < grid[0] <= ops.GRID_X_MAX
                assert 0 < grid[1] <= ops.GRID_YZ_MAX and 0 < grid[2] <= ops.GRID_YZ_MAX
    assert (seen == 1).all()
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        ops.check_grid(B, H, Sq, 4104, dt, Skv)


def test_split_refuses_what_its_workspace_cannot_hold():
    """One query tile of one (batch, head) past the workspace (Skv past
    2,097,152 keys), and Skv = 0, raise; 2,097,152 keys is one piece a
    tile."""
    assert ops.split_pieces(1, 1, 256, 2**21) == [(0, 1, 0, 1), (0, 1, 1, 1)]
    with pytest.raises(ValueError, match="workspace"):
        ops.split_pieces(1, 1, 128, 2**21 + 1)
    with pytest.raises(ValueError, match="workspace"):
        ops.check_grid(1, 1, 128, 2056, torch.float32, 2**21 + 1)
    with pytest.raises(ValueError, match="Skv"):
        ops.split_pieces(1, 1, 128, 0)
