"""The flash-attention kernel's plain version and wrapper
(``repro_torch.kernels.flash_attention``) against the JAX package.

On the CPU the wrapper runs the plain version, which must match the JAX
package's oracle ``attention_ref`` (atol 2e-6 in fp32, as the JAX package
holds its own kernel; 2e-2 in bf16, the bf16 bound of
``tests/test_kernels.py``) and the Pallas kernel itself, run in interpret
mode as the JAX package's tests run it. The CUDA kernel is held against the
same plain version on the card by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro_torch.kernels.flash_attention import attention_ref, flash_attention

TOL = {"float32": 2e-6, "bfloat16": 2e-2}


def _inputs(seed, B, Sq, H, KV, D, Skv=None, dtype="float32"):
    rng = np.random.default_rng(seed)
    Skv = Skv or Sq
    q = (rng.standard_normal((B, Sq, H, D)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((B, Skv, KV, D)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((B, Skv, KV, D)) * 0.3).astype(np.float32)
    jt = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    return jt, tt


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal,window", [
    ((2, 64, 4, 4, 32), True, None),        # G = 1
    ((1, 96, 8, 2, 64), True, 17),          # G = 4, window
    ((2, 50, 8, 1, 32), False, None),       # G = 8, no mask
    ((1, 128, 4, 2, 128), False, 40),       # window without causal
    ((1, 33, 4, 2, 64), True, 1),           # the diagonal only
])
def test_plain_version_matches_reference_oracle(dtype, shape, causal, window):
    (jq, jk, jv), (q, k, v) = _inputs(1, *shape, dtype=dtype)
    want = j_attention_ref(jq, jk, jv, causal=causal, window=window)
    got = attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype], rtol=0)


def test_plain_version_with_other_kv_length():
    (jq, jk, jv), (q, k, v) = _inputs(2, 1, 40, 4, 2, 32, Skv=72)
    for causal in (True, False):
        want = j_attention_ref(jq, jk, jv, causal=causal)
        got = attention_ref(q, k, v, causal=causal)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-6, rtol=0)


@pytest.mark.parametrize("S,H,KV,window", [
    (256, 2, 2, None),      # G = 1
    (512, 4, 2, None),      # G = 2
    (256, 8, 1, None),      # G = 8, the serve path's group
    (512, 2, 1, 128),       # sliding window
])
def test_plain_version_matches_pallas_kernel_interpreted(S, H, KV, window):
    """The Pallas kernel (interpret mode) in bf16 against the port's plain
    version: the bf16 bound, 2e-2."""
    (jq, jk, jv), (q, k, v) = _inputs(3, 1, S, H, KV, 64, dtype="bfloat16")
    want = flash_attention_pallas(jq, jk, jv, causal=True, window=window,
                                  interpret=True)
    got = flash_attention(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2, rtol=0)


def test_pallas_kernel_fp32_agrees_with_plain_version():
    (jq, jk, jv), (q, k, v) = _inputs(4, 1, 256, 4, 2, 32)
    want = flash_attention_pallas(jq, jk, jv, causal=True, interpret=True)
    got = flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-6, rtol=0)


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_no_launch():
    _, (q, k, v) = _inputs(5, 1, 24, 4, 2, 32)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True, window=8)
    assert torch.equal(got, attention_ref(q, k, v, causal=True, window=8))
    assert flash_attention.launches == before


def test_wrapper_rejects_a_window_below_one():
    _, (q, k, v) = _inputs(6, 1, 8, 2, 1, 32)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=0)


def test_wrapper_rejects_other_devices():
    _, (q, k, v) = _inputs(7, 1, 8, 2, 1, 32)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
