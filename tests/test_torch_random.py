"""The port's threefry PRNG (``repro_torch.random``) against ``jax.random``.

Every JAX call runs under ``jax.threefry_partitionable(False)``, the
semantics the JAX package's goldens were recorded with. Keys, raw bits and
uniforms must be bit-equal; exponentials are ``-log1p(-u)`` and may differ
by 1 ulp, because PyTorch's and XLA's ``log1p`` round differently.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import channel as jchannel
from repro.data.pipeline import client_sample_keys as j_client_sample_keys
from repro_torch import random as prng
from repro_torch.core import channel as tchannel
from repro_torch.data.pipeline import client_sample_keys

SEEDS = [0, 1, 7, 12345, 2**31 - 1]


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint32).astype(np.int64)


def _ulps(a, b) -> int:
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


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
    with jax.threefry_partitionable(False):
        k = jax.random.PRNGKey(seed)
        t = prng.PRNGKey(seed)
        for shape in [(8,), (50,), (4, 9)]:
            e_j = jax.random.exponential(k, shape, jnp.float32)
            e_t = prng.exponential(t, shape)
            assert _ulps(e_j, e_t) <= 1, shape


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
                assert _ulps(f_j, f_t) <= 1, (seed, r)


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
    """Uniforms bit-equal; ``-log(-log(u))`` through PyTorch's float32
    ``log`` and XLA's, which round apart by an ulp on some inputs
    (ROADMAP C-9): equal to within 2 ulps of each log's result."""
    with jax.threefry_partitionable(False):
        k = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
        want = np.asarray(jax.random.gumbel(k, shape, jnp.float32))
        got = prng.gumbel(prng.fold_in(prng.PRNGKey(seed), 11), shape).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        # the inner log is -log(u) > 0; an ulp there moves g by at most
        # ulp(e^{-g}) / e^{-g} in absolute terms (~1.2e-7), plus the outer ulp
        np.testing.assert_allclose(got, want, rtol=3e-7, atol=3e-7)
        assert np.mean(got == want) > 0.5


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
