"""The training path's flash attention against the JAX package.

``ref.flash_fwd_ref`` against ``repro.models.attention._flash_fwd_impl``
(the chunked online-softmax forward, which also returns the log-sum-exp),
and ``ref.flash_bwd_ref`` against ``jax.vjp`` of ``_flash_core`` (the
blockwise recompute of its custom VJP), at S = 2048 (two chunks of 1024
rows and keys), D = 32, causal and with a 256 window. Then the wrapper's
``FlashAttention`` on CPU tensors: its gradients, its counters, and that
it takes over only under grad.

Tolerances: out rtol 1e-5 and lse atol 1e-5 (the same fp32 operations in
the same chunks; the sums inside an einsum may add in another order);
dq, dk, dv within 1e-4 of their scale (a few fp32 roundings in other
orders over 2048 keys).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     flash_bwd_ref,
                                                     flash_fwd_ref)

B, S, H, KV, D = 1, 2048, 4, 2, 32
G = H // KV
CASES = [(True, None), (True, 256)]

from test_torch_train import one_torch_thread  # noqa: E402,F401


def _inputs(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, k, v = ((rng.standard_normal(shape) * 0.5).astype(dtype)
               for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    dout = rng.standard_normal((B, S, H, D)).astype(dtype)
    return q, k, v, dout


def _scale_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("causal,window", CASES, ids=["causal", "window256"])
def test_forward_and_lse_match_the_reference(causal, window):
    q, k, v, _ = _inputs(1)
    with jax.threefry_partitionable(False):
        want_out, want_lse = jattn._flash_fwd_impl(
            jnp.asarray(q).reshape(B, S, KV, G, D), jnp.asarray(k),
            jnp.asarray(v), scale=1.0 / D ** 0.5, causal=causal, window=window)
    out, lse = flash_fwd_ref(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal, window=window)
    assert lse.shape == (B, KV, G, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(want_out).reshape(B, S, H, D),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("causal,window", CASES, ids=["causal", "window256"])
def test_backward_matches_the_reference_vjp(causal, window):
    q, k, v, dout = _inputs(2)
    scale = 1.0 / D ** 0.5
    jq = jnp.asarray(q).reshape(B, S, KV, G, D)
    with jax.threefry_partitionable(False):
        _, vjp = jax.vjp(lambda a, b, c: jattn._flash_core(scale, causal,
                                                            window, a, b, c),
                         jq, jnp.asarray(k), jnp.asarray(v))
        jdq, jdk, jdv = vjp(jnp.asarray(dout).reshape(B, S, KV, G, D))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = flash_fwd_ref(tq, tk, tv, causal=causal, window=window)
    dq, dk, dv = flash_bwd_ref(tq, tk, tv, out, lse, torch.from_numpy(dout),
                               causal=causal, window=window)
    for name, got, want in (("dq", dq, np.asarray(jdq).reshape(B, S, H, D)),
                            ("dk", dk, jdk), ("dv", dv, jdv)):
        assert got.dtype == torch.float32
        assert _scale_err(got.numpy(), want) <= 1e-4, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_gradients_on_the_cpu(dtype):
    """Under grad the wrapper's Function runs ``flash_fwd_ref`` forward and
    ``flash_bwd_ref`` backward on CPU tensors: its gradients equal autograd
    through the direct plain version (fp32 within 1e-4 of their scale;
    bf16, whose inputs and gradients round to bf16, within 2e-2), it
    counts one backward call and no kernel launch, and it returns
    gradients in the inputs' type."""
    q, k, v, dout = _inputs(3)
    q, k, v = (torch.from_numpy(a).to(dtype).requires_grad_(True)
               for a in (q, k, v))
    dout_t = torch.from_numpy(dout).to(dtype)
    launches, calls = ops.flash_attention.launches, ops.flash_attention.backward_calls
    out = flash_attention(q, k, v, causal=True, window=256)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, (q, k, v), dout_t)
    assert ops.flash_attention.backward_calls == calls + 1
    assert ops.flash_attention.launches == launches
    qf, kf, vf = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    want = torch.autograd.grad(attention_ref(qf, kf, vf, causal=True, window=256),
                               (qf, kf, vf), dout_t.float())
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype, name
        assert _scale_err(g.float().numpy(), w.numpy()) <= tol, name


def test_without_grad_the_wrapper_takes_the_serve_path():
    """Under ``no_grad``, or with inputs that need no grad, the wrapper is
    the serve path's: the direct plain version on the CPU, no graph."""
    q, k, v, _ = _inputs(4)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    want = attention_ref(tq, tk, tv, causal=True)
    assert torch.equal(flash_attention(tq, tk, tv, causal=True), want)
    tq.requires_grad_(True)
    with torch.no_grad():
        got = flash_attention(tq, tk, tv, causal=True)
    assert got.grad_fn is None and torch.equal(got, want)
