"""The port's threefry PRNG (``repro_torch.random``) against ``jax.random``.

Every JAX call runs under ``jax.threefry_partitionable(False)``, the
semantics the JAX package's goldens were recorded with. Keys, raw bits,
uniforms and the float transforms of them (exponential, Gumbel, normal)
must be bit-equal: the port computes ``log``, ``log1p`` and ``erf_inv`` as
XLA:CPU does (``repro_torch.xla_math``), which these tests also hold bit
for bit against XLA on millions of inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import channel as jchannel
from repro.data.pipeline import client_sample_keys as j_client_sample_keys
from jax.scipy.special import erfinv as j_erfinv

from repro_torch import random as prng
from repro_torch import xla_math
from repro_torch.core import channel as tchannel
from repro_torch.data.pipeline import client_sample_keys
from test_torch_train import one_torch_thread  # noqa: F401  (torch on one thread)

SEEDS = [0, 1, 7, 12345, 2**31 - 1]


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint32).astype(np.int64)


def _assert_bits(want, got, msg=""):
    """Equal float32 bit patterns (NaNs included)."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert want.shape == got.shape, msg
    bad = want.view(np.int32) != got.view(np.int32)
    assert not bad.any(), (f"{msg}: {int(bad.sum())} of {bad.size} differ, "
                           f"e.g. {want[bad][:3]} vs {got[bad][:3]}")


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split_are_bit_equal(seed):
    with jax.threefry_partitionable(False):
        k = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(_u32(k), prng.PRNGKey(seed).numpy())
        t = prng.PRNGKey(seed)
        for d in [0, 1, 3, 1 << 20, 2 << 20, 7 << 20, 4_000_000_000]:
            np.testing.assert_array_equal(
                _u32(jax.random.fold_in(k, d)), prng.fold_in(t, d).numpy(),
                err_msg=f"fold_in {d}")
        for n in [1, 2, 3, 8, 50]:
            np.testing.assert_array_equal(
                _u32(jax.random.split(k, n)), prng.split(t, n).numpy(),
                err_msg=f"split {n}")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (5,), (8,), (50,), (2, 16), (3, 7)])
def test_bits_and_uniform_are_bit_equal(seed, shape):
    with jax.threefry_partitionable(False):
        k = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
        t = prng.fold_in(prng.PRNGKey(seed), 3)
        np.testing.assert_array_equal(_u32(jax.random.bits(k, shape)),
                                      prng.random_bits(t, shape).numpy())
        u_j = np.asarray(jax.random.uniform(k, shape))
        u_t = prng.uniform(t, shape).numpy()
        np.testing.assert_array_equal(u_j.view(np.int32), u_t.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_exponential_within_one_ulp(seed):
    """Bit-equal since the port's ``log1p`` is XLA's (the name dates from
    when PyTorch's ``log1p`` left up to 1 ulp, ROADMAP C-5)."""
    with jax.threefry_partitionable(False):
        k = jax.random.PRNGKey(seed)
        t = prng.PRNGKey(seed)
        for shape in [(8,), (50,), (4, 9)]:
            e_j = jax.random.exponential(k, shape, jnp.float32)
            e_t = prng.exponential(t, shape)
            _assert_bits(e_j, e_t, str(shape))


@pytest.mark.parametrize("seed", [0, 3])
def test_batched_keys_match_vmap(seed):
    """A [N, 2] key batch draws as ``jax.vmap`` over the keys — the shape
    the per-client batch sampler uses."""
    with jax.threefry_partitionable(False):
        ks = jax.random.split(jax.random.PRNGKey(seed), 6)
        want = jax.vmap(lambda kk: jax.random.uniform(kk, (2, 16)))(ks)
        got = prng.uniform(prng.split(prng.PRNGKey(seed), 6), (2, 16))
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("n", [1, 8, 50])
def test_client_sample_keys_match(n):
    with jax.threefry_partitionable(False):
        base = jax.random.fold_in(jax.random.PRNGKey(0), 2 << 20)
        tbase = prng.fold_in(prng.PRNGKey(0), 2 << 20)
        for r in [0, 1, 11, 149]:
            np.testing.assert_array_equal(
                _u32(j_client_sample_keys(base, r, n)),
                client_sample_keys(tbase, r, n).numpy(), err_msg=f"round {r}")


@pytest.mark.parametrize("n", [8, 50])
def test_round_fading_within_one_ulp(n):
    with jax.threefry_partitionable(False):
        for seed in [0, 5]:
            for r in [0, 1, 7, 100]:
                f_j = jchannel.round_fading(jax.random.PRNGKey(seed), r, n)
                f_t = tchannel.round_fading(prng.PRNGKey(seed), r, n)
                _assert_bits(f_j, f_t, str((seed, r)))


def test_prngkey_rejects_out_of_range_seed():
    with pytest.raises(ValueError):
        prng.PRNGKey(2**31)
    assert prng.PRNGKey(-1).tolist() == [0, 0xFFFFFFFF]
    assert prng.PRNGKey(3).dtype == torch.int64


@pytest.mark.parametrize("seed", [0, 1, 12345])
@pytest.mark.parametrize("shape,lo,hi", [
    ((4, 64), 0, 512),             # the serve prompt at smoke width
    ((2, 2048), 0, 32000),         # TinyLlama's vocabulary
    ((7,), -5, 5), ((3, 5), 0, 1), ((9,), 3, 3), ((6,), 10, 2),
    ((50,), -(2**31), 2**31 - 1), ((33,), 0, 1 << 20),
])
def test_randint_is_bit_equal(seed, shape, lo, hi):
    with jax.threefry_partitionable(False):
        k = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.randint(k, shape, lo, hi))
        got = prng.randint(prng.PRNGKey(seed), shape, lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("shape", [(5,), (2, 512), (4, 32000)])
def test_gumbel_matches_to_a_rounding_of_log(seed, shape):
    """``-log(-log(u))`` through XLA's float32 ``log``: bit-equal (the name
    dates from when PyTorch's ``log`` rounded apart, ROADMAP C-9)."""
    with jax.threefry_partitionable(False):
        k = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
        want = np.asarray(jax.random.gumbel(k, shape, jnp.float32))
        got = prng.gumbel(prng.fold_in(prng.PRNGKey(seed), 11), shape).numpy()
        assert got.dtype == np.float32
        _assert_bits(want, got, str(shape))


# ------------------------------------------------ XLA's float32 math ----
def _xla(fn, x: np.ndarray) -> np.ndarray:
    return np.asarray(jax.jit(fn)(jnp.asarray(x)))


def _every_positive_float(stride: int) -> np.ndarray:
    """Every ``stride``-th float32 bit pattern from +0 to +inf
    (denormals included)."""
    return (np.arange(0, 0x7F800001, stride, dtype=np.int64)
            .astype(np.uint32).view(np.float32))


SPECIAL = np.array([0.0, -0.0, 1e-40, -1e-40, 1.0, -1.0, 2.0, -2.0, 1e-30,
                    0.41421354, -0.41421354, 0.9999999, -0.99999994,
                    np.inf, -np.inf], np.float32)


@pytest.mark.parametrize("name,jfn,tfn,make", [
    ("log", jnp.log, xla_math.log_xla,
     lambda r: np.concatenate([_every_positive_float(331), r.random(1 << 20, np.float32)])),
    ("log1p", jnp.log1p, xla_math.log1p_xla,
     lambda r: np.concatenate([_every_positive_float(331), -r.random(1 << 20, np.float32),
                               (r.standard_normal(1 << 18) * 8).astype(np.float32)])),
    ("erfinv", j_erfinv, xla_math.erfinv_xla,
     lambda r: r.random(1 << 21, np.float32) * 2 - 1),
])
def test_xla_math_is_bit_equal_to_xla_cpu(name, jfn, tfn, make):
    """Each function on >= 1M inputs (every 331st positive float pattern,
    and the draws' own ranges) and the special values, bit for bit."""
    x = np.concatenate([make(np.random.default_rng(5)), SPECIAL])
    if name == "erfinv":            # outside [-1, 1] only NaN's payload differs
        x = x[np.abs(x) <= 1.0]
    _assert_bits(_xla(jfn, x), tfn(torch.from_numpy(x)).numpy(), name)


def test_fma_f32_rounds_once():
    """``fma_f32`` against the product and sum rounded once from exact
    rationals, on inputs where two roundings would differ."""
    from fractions import Fraction
    rng = np.random.default_rng(2)
    a = rng.standard_normal(3000).astype(np.float32)
    b = rng.standard_normal(3000).astype(np.float32)
    # c cancels most of the product, so its low bits decide the rounding
    c = -(a.astype(np.float64) * b).astype(np.float32)
    c = np.nextafter(c, np.float32(np.inf) * np.sign(rng.standard_normal(3000)))
    got = xla_math.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(c)).numpy()
    two_roundings = (a * b) + c
    assert np.any(got != two_roundings)
    for i in range(a.size):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        f = np.float32(float(exact))
        near = [np.nextafter(f, np.float32(-np.inf)), f,
                np.nextafter(f, np.float32(np.inf))]
        best = min(near, key=lambda v: (abs(Fraction(float(v)) - exact),
                                        int(np.array(v).view(np.int32)) & 1))
        assert got[i] == best, i


@pytest.mark.parametrize("draw", ["exponential", "gumbel", "normal"])
def test_draws_are_bit_equal_on_a_million(draw):
    """>= 1M draws of each transform over several seeds and shapes, equal
    to ``jax.random``'s bit for bit."""
    jfn = getattr(jax.random, draw)
    tfn = getattr(prng, draw)
    total = 0
    with jax.threefry_partitionable(False):
        for seed, shape in [(0, (1 << 19,)), (7, (513, 1021)), (12345, (3, 50)),
                            (2**31 - 1, (1000, 5)), (42, (1,))]:
            k = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
            want = np.asarray(jfn(k, shape, jnp.float32))
            got = tfn(prng.fold_in(prng.PRNGKey(seed), 5), shape).numpy()
            _assert_bits(want, got, f"{draw} {seed} {shape}")
            total += want.size
    assert total >= 1_000_000


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("shape", [(1 << 19,), (3, 3, 1, 32), (512, 10)])
def test_truncated_normal_is_bit_equal(seed, shape):
    """``jax.random.truncated_normal(key, -2, 2, ...)``, the fan-in
    initializer's draw (``models.cnn.init_cnn``)."""
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.truncated_normal(
            jax.random.PRNGKey(seed), -2.0, 2.0, shape, jnp.float32))
    got = prng.truncated_normal(prng.PRNGKey(seed), -2.0, 2.0, shape)
    _assert_bits(want, got.numpy(), str(shape))
    with pytest.raises(ValueError, match="bounds"):
        prng.truncated_normal(prng.PRNGKey(seed), -1.0, 2.0, shape)


@pytest.mark.parametrize("seed", [0, 1, 99])
@pytest.mark.parametrize("shape", [(5,), (50,), (3, 3, 8, 16)])
def test_normal_is_bit_equal(seed, shape):
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
        got = prng.normal(prng.PRNGKey(seed), shape).numpy()
        assert got.dtype == np.float32
        _assert_bits(want, got, str(shape))


@pytest.mark.parametrize("seed", [0, 3, 99])
@pytest.mark.parametrize("shape", [(1, 10), (4, 512), (2, 32000)])
def test_categorical_ids_are_equal(seed, shape):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal(shape) * 2.0).astype(np.float32)
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(seed)
        tkey = prng.PRNGKey(seed)
        for _ in range(4):                      # the serve loop's key chain
            key, sk = jax.random.split(key)
            tkey, tsk = prng.split(tkey)
            want = np.asarray(jax.random.categorical(sk, jnp.asarray(logits)))
            got = prng.categorical(tsk, torch.from_numpy(logits))
            np.testing.assert_array_equal(got.numpy(), want)
