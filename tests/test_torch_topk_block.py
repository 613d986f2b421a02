"""Block top-k of one vector (ROADMAP B-7): the port's wrapper on CPU
tensors (its plain PyTorch version) against the JAX package's
``block_topk_sparsify`` (the Pallas kernel, interpreted) and its jitted
``block_topk_ref``, and the rest of ``fl/compression.py`` against theirs.

Outputs are compared bit for bit on every lane, bf16 in its own type.
Dropped lanes are +0.0 whatever they held: the Pallas kernel's contract in
both types, and the jitted reference's in fp32 (XLA turns ``x * mask``
into a select). The eager reference, and the jitted one in bf16, multiply:
a dropped NaN stays NaN and a dropped negative lane is -0.0 there
(ROADMAP C-11), and those lanes are the only difference. The CUDA kernel
is held to this plain version on the card by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl.compression import block_topk as j_block_topk
from repro.fl.compression import dequantize_int8 as j_dequantize_int8
from repro.fl.compression import global_topk as j_global_topk
from repro.fl.compression import quantize_int8 as j_quantize_int8
from repro.kernels.topk_sparsify.ops import block_topk_sparsify as j_pallas
from repro.kernels.topk_sparsify.ref import block_topk_ref as j_ref

from repro_torch.fl.compression import (block_topk, dequantize_int8,
                                        global_topk, quantize_int8)
from repro_torch.kernels.topk_sparsify import block_topk_sparsify, keep_count
from repro_torch.kernels.topk_sparsify import ops as topk_ops

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(x: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _bits(a) -> np.ndarray:
    """float32 bit patterns (bf16 widens exactly)."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy().view(np.int32)
    return np.asarray(jnp.asarray(a).astype(jnp.float32)).view(np.int32)


def _differs_only_by_the_product(got, other):
    """``other`` equals ``got`` but on dropped lanes, where it holds the
    IEEE product ``x * 0``: NaN or -0.0 (ROADMAP C-11)."""
    g, o = _bits(got), _bits(other)
    differ = g != o
    assert not (differ & (g != 0)).any()
    assert (np.isnan(o.view(np.float32)[differ])
            | (o[differ] == np.int32(-2**31))).all()


def _tricky(n=2 * 4096 + 300, seed=1):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=n).astype(np.float32)
    v[::7] = np.nan
    v[1::11] = np.inf
    v[2::13] = -np.inf
    v[3::5] = -0.0
    v[4096:4096 + 900] = np.round(v[4096:4096 + 900] * 2) / 2     # ties
    v[4096 + 1000:4096 + 1400] = -0.75
    return v


@pytest.mark.parametrize("n,block", [(4096, 4096), (8192, 2048), (10000, 4096),
                                     (300, 256), (65536, 4096)])
@pytest.mark.parametrize("gamma", [0.1, 0.37, 0.5, 1.0])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_version_matches_pallas_and_ref(n, block, gamma, dtype):
    x = np.random.default_rng(n + int(gamma * 10)).normal(size=n).astype(np.float32)
    jv, tv = _pair(x, dtype)
    got, k = block_topk_sparsify(tv, gamma, block=block)
    want, k1 = j_pallas(jv, gamma, block=block)
    ref, k2 = jax.jit(lambda v: j_ref(v, gamma, block=block))(jv)
    assert k == k1 == k2 == keep_count(gamma, block)
    assert got.dtype == tv.dtype and got.shape == tv.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if dtype == "float32":
        np.testing.assert_array_equal(_bits(got), _bits(ref))
    else:
        _differs_only_by_the_product(got, ref)


@pytest.mark.parametrize("gamma,block", [(0.1, 4096), (0.25, 1024), (0.5, 256),
                                         (1.0, 4096), (0.0, 2048)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ties_nan_inf_and_signed_zeros(gamma, block, dtype):
    """Dropped lanes are +0.0, as in the Pallas kernel and the jitted
    reference; at k = block the NaN lanes are dropped (no all-full skip)."""
    jv, tv = _pair(_tricky(), dtype)
    got, k = block_topk_sparsify(tv, gamma, block=block)
    want, _ = j_pallas(jv, gamma, block=block)
    ref, _ = jax.jit(lambda v: j_ref(v, gamma, block=block))(jv)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if dtype == "float32":
        np.testing.assert_array_equal(_bits(got), _bits(ref))
    else:
        _differs_only_by_the_product(got, ref)
    _differs_only_by_the_product(got, j_ref(jv, gamma, block=block)[0])
    if k == block:
        assert not torch.isnan(got).any()


@pytest.mark.parametrize("gamma,block", [(0.1, 4096), (0.25, 1024), (0.5, 256)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_the_all_ones_nan_keeps_the_pallas_kernels_mask(gamma, block, dtype):
    """A NaN with every mantissa bit set (|x| = 0x7fffffff) among the
    tie/NaN lanes: the bisection's max + 1 wraps, its threshold ends at the
    pattern 0x80000001 (a negative denormal), and every non-NaN, non-zero
    lane of that block is kept, more than k. XLA on the CPU compares the
    denormal as 0.0, so a zero there is a tie that does not fit and comes
    out +0.0; the plain version compares denormals as zero too (ROADMAP
    C-16), so every lane equals the Pallas kernel's. The sort-based jnp
    oracle keeps k lanes there, so it is not compared on this input.
    bf16's all-ones NaN widens to 0x7fff0000, below the wrap."""
    v = _tricky()
    v.view(np.uint32)[[5, 4096 + 17]] = (0x7FFFFFFF, 0xFFFFFFFF)
    jv, tv = _pair(v, dtype)
    if dtype == "bfloat16":
        tv.view(torch.int16)[[5, 4096 + 17]] = torch.tensor([0x7FFF, -1],
                                                            dtype=torch.int16)
        jv = jnp.asarray(tv.view(torch.int16).numpy()).view(jnp.bfloat16)
    got, k = block_topk_sparsify(tv, gamma, block=block)
    want, _ = j_pallas(jv, gamma, block=block)
    g, w = _bits(got), _bits(want)
    np.testing.assert_array_equal(g, w)
    if dtype == "bfloat16":
        return
    for lane in (5, 4096 + 17):
        lo = lane // block * block
        blk = v[lo:lo + block]
        kept = np.where(np.isnan(blk) | (blk == 0), np.float32(0), blk)
        np.testing.assert_array_equal(g[lo:lo + block], kept.view(np.int32))
        assert int((~np.isnan(blk)).sum()) > k


def _denormal_vector(dtype: str, seed=0) -> np.ndarray:
    """Blocks of 1024 (as uint32 fp32 patterns, or uint16 bf16 ones): block 0
    holds a few normals and many denormals of either sign (a mid k's
    threshold is a denormal, C-16 (b)); block 1 a few normals, zeros, then
    denormals (the threshold is 0.0 and denormals come after zeros, C-16
    (c)); block 2 normals with one denormal (kept only at large k)."""
    rng, n = np.random.default_rng(seed), 3 * 1024
    if dtype == "float32":
        normal = lambda m: rng.normal(size=m).astype(np.float32).view(np.uint32)  # noqa: E731
        man, sign, out = 1 << 23, 0x80000000, np.zeros(n, np.uint32)
    else:
        normal = lambda m: (rng.normal(size=m).astype(np.float32).view(np.uint32)  # noqa: E731
                            >> 16).astype(np.uint16)
        man, sign, out = 1 << 7, 0x8000, np.zeros(n, np.uint16)
    den = lambda m: (rng.integers(1, man, size=m)  # noqa: E731
                     | np.where(rng.random(m) < 0.5, sign, 0)).astype(out.dtype)
    out[0:1024:40] = normal(len(out[0:1024:40]))
    out[3:1024:7] = den(len(out[3:1024:7]))
    out[1024:1024 + 20] = normal(20)
    out[1024 + 512:2048:9] = den(len(out[1024 + 512:2048:9]))
    out[2048:] = normal(1024)
    out[2048 + 700] = den(1)[0]
    return out


def _from_bits(bits: np.ndarray, dtype: str):
    if dtype == "float32":
        return _pair(bits.view(np.float32), dtype)
    tv = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    return jnp.asarray(bits).view(jnp.bfloat16), tv


@pytest.mark.parametrize("gamma", [0.03, 0.1, 0.55, 0.99])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_denormals_compare_as_zero_as_in_the_reference(gamma, dtype):
    """C-16 (b) and (c) on the one-vector path: XLA on the CPU compares a
    denormal magnitude or threshold as 0.0, so denormals tie with zeros
    and are kept in index order while they fit; a kept denormal keeps its
    bits (the product is a select). The plain version equals the Pallas
    kernel on every lane, bf16 in its own type."""
    jv, tv = _from_bits(_denormal_vector(dtype), dtype)
    got, _ = block_topk_sparsify(tv, gamma, block=1024)
    want, _ = j_pallas(jv, gamma, block=1024)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if gamma >= 0.55:
        # some denormal is kept, with its bits
        kept = _bits(got)[_bits(got) != 0]
        assert ((kept & 0x7F800000) == 0).any()


@pytest.mark.parametrize("gammas", [[0.03, 0.1, 0.99], [0.55, 1.0, 0.2]])
def test_denormal_rows_match_the_reference_batch_top_k(gammas):
    """C-16 on the rows path (the FL round's top-k): the port's
    ``batch_block_topk`` on rows holding the denormal blocks against the
    reference's jitted ``batch_block_topk`` (its bisection fast path) and
    its Pallas rows kernel (interpreted), bit for bit."""
    from repro.fl.compression import batch_block_topk as j_batch
    from repro_torch.fl.compression import batch_block_topk

    base = np.tile(_denormal_vector("float32"), 4).view(np.float32)
    mat = np.stack([np.roll(base, 1000 * i) for i in range(3)])
    g = np.asarray(gammas, np.float32)
    got = _bits(batch_block_topk(torch.from_numpy(mat), torch.from_numpy(g)))
    for use_pallas in (False, True):
        want = jax.jit(lambda m, g, p=use_pallas: j_batch(m, g, use_pallas=p))(
            jnp.asarray(mat), jnp.asarray(g))
        np.testing.assert_array_equal(got, _bits(want))


def test_keeps_exactly_k_per_block_and_the_largest():
    x = np.random.default_rng(0).normal(size=8192).astype(np.float32)
    got, k = block_topk_sparsify(torch.from_numpy(x), 0.25, block=2048)
    nnz = (got != 0).reshape(4, 2048).sum(dim=1)
    assert (nnz == k).all() and k == 512
    mag = np.abs(x).reshape(4, 2048)
    kept = (got != 0).numpy().reshape(4, 2048)
    for b in range(4):
        assert mag[b][kept[b]].min() >= mag[b][~kept[b]].max()


def test_wrapper_refuses_what_the_kernel_does_not_take():
    v = torch.zeros(1000)
    for block in (0, -128):
        with pytest.raises(ValueError, match="at least 1"):
            block_topk_sparsify(v, 0.5, block=block)
    # a width past the kernels' int lane indices raises on the card
    with pytest.raises(ValueError, match="wider than the kernels take"):
        topk_ops._check_block(topk_ops.MAX_BLOCK + 1, True)
    with pytest.raises(ValueError, match="1 dim"):
        block_topk_sparsify(torch.zeros(4, 256), 0.5, block=256)


@pytest.mark.parametrize("block", [256, 4096])
def test_compression_block_topk_matches_the_reference(block):
    x = _tricky(seed=3)
    jv, tv = _pair(x, "float32")
    got, k = block_topk(tv, 0.37, block=block)
    want, kj = j_block_topk(jv, 0.37, block=block, use_pallas=True)
    assert k == kj
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("gamma", [0.01, 0.1, 0.5, 1.0])
def test_global_topk_matches_the_reference(gamma):
    rng = np.random.default_rng(5)
    x = rng.normal(size=5000).astype(np.float32)
    x[:400] = np.round(x[:400])                   # ties at the threshold
    got, k = global_topk(torch.from_numpy(x), gamma)
    want, kj = j_global_topk(jnp.asarray(x), gamma)
    assert k == kj
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_int8_quantizer_matches_the_reference():
    x = np.random.default_rng(6).normal(size=3000).astype(np.float32) * 3.0
    x[::97] = np.nan
    x[5::101] = -np.inf
    for v in (x, np.zeros(8, np.float32)):
        q, scale = quantize_int8(torch.from_numpy(v))
        qj, sj = j_quantize_int8(jnp.asarray(v))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(_bits(dequantize_int8(q, scale)),
                                      _bits(j_dequantize_int8(qj, sj)))
