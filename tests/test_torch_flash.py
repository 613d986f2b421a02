"""The flash-attention kernel's plain version and wrapper
(``repro_torch.kernels.flash_attention``) against the JAX package.

On the CPU the wrapper runs the plain version, which must match the JAX
package's oracle ``attention_ref`` (atol 2e-6 in fp32, as the JAX package
holds its own kernel; 2e-2 in bf16, the bf16 bound of
``tests/test_kernels.py``) and the Pallas kernel itself, run in interpret
mode as the JAX package's tests run it. The CUDA kernel is held against the
same plain version on the card by ``chip_smoke.py``. A CPU emulation of the
bf16 tensor-core kernel's numerics (``csrc/flash_attention_sm90.cu``: its
tiles, masks and skipped tiles, P rounded to bf16 before P V) shows that
its one numeric change fits the bf16 gate before it runs on a card; CPU
models of the fp32 kernels (``csrc/flash_attention.cu``, the SIMT kernel up
to a head dim of 128: its tiles, the order of its sums and its per-tile
rescale; above, the 3xTF32 tensor-core kernel of ``csrc/flash_tf32.cuh``,
``tests/torch_flash_models.tf32_model``) hold their arithmetic to the fp32
gate the same way. Both run at head dims 16 to 256, zero-padded to the
width each kernel computes on, as the kernels and their wrapper
(``ops.pad_head_dim``) pad.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_attention import ops
from torch_flash_models import tf32_model

TOL = {"float32": 2e-6, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one intra-op thread: the suite runs several
    workers on the machine's cores, and a process with a thread a core
    each slows all of them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [36, 160, 256])
def test_plain_version_matches_pallas_kernel_at_other_head_dims(dtype, D):
    """Head dims the kernels compute on padded widths (36: 64 columns,
    bf16 rows padded to 40; 160; 256, Gemma's): the interpreted Pallas
    kernel, which takes any D, against the port's plain version, within
    TOL."""
    (jq, jk, jv), (q, k, v) = _inputs(9, 1, 256, 4, 2, D, dtype=dtype)
    want = flash_attention_pallas(jq, jk, jv, causal=True, interpret=True)
    got = flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("D,multiple", [(1, 4), (3, 4), (36, 8), (13, 8), (256, 8)])
def test_head_dim_padding_keeps_the_function(D, multiple):
    """``pad_head_dim`` zero-pads the last dim to the next multiple (and
    leaves a whole one alone); attention on the padded q, k and v with the
    scale of the real D, sliced to D columns, is the attention of the
    unpadded inputs within 1e-6: what the wrapper launches for a D whose
    rows are no whole 16-byte copies."""
    _, (q, k, v) = _inputs(10, 1, 40, 4, 2, D, Skv=56)
    qp, kp, vp = (ops.pad_head_dim(t, multiple) for t in (q, k, v))
    Dp = -(-D // multiple) * multiple
    assert qp.shape == (1, 40, 4, Dp) and kp.shape == vp.shape == (1, 56, 2, Dp)
    assert (qp is q) == (Dp == D)
    assert torch.equal(qp[..., :D], q) and not qp[..., D:].any()
    s = torch.einsum("bqkgd,bskd->bkgqs", qp.reshape(1, 40, 2, 2, Dp), kp) / D ** 0.5
    out = torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(s, dim=-1), vp)
    got = out.reshape(1, 40, 4, Dp)
    assert not got[..., D:].any()
    want = attention_ref(q, k, v, causal=False)
    np.testing.assert_allclose(got[..., :D].numpy(), want.numpy(), atol=1e-6, rtol=0)


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


def test_kernel_calls_under_grad_raise_and_the_plain_version_keeps_autograd():
    """C-14 (closed): a call under grad no longer raises on any device; it
    goes through the wrapper's ``FlashAttention`` (the kernel, or on the CPU
    ``flash_fwd_ref``, forward; ``flash_bwd_ref`` backward), so the
    gradient reaches q, k and v. Inputs that need no grad, or grad mode
    off, keep the serve path: no graph, no backward call."""
    _, (q, k, v) = _inputs(8, 1, 16, 2, 1, 32)
    calls = ops.flash_attention.backward_calls
    with torch.no_grad():
        assert flash_attention(q.requires_grad_(True), k, v).grad_fn is None
    assert flash_attention(q.detach(), k, v).grad_fn is None
    out = flash_attention(q, k, v.requires_grad_(True), causal=True)
    assert "FlashAttention" in type(out.grad_fn).__name__
    out.square().sum().backward()
    assert ops.flash_attention.backward_calls == calls + 1
    for t in (q, v):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
        assert float(t.grad.abs().sum()) > 0
    assert k.grad is None
    qf, vf = (t.detach().clone().requires_grad_(True) for t in (q, v))
    attention_ref(qf, k, vf, causal=True).square().sum().backward()
    np.testing.assert_allclose(q.grad.numpy(), qf.grad.numpy(), atol=1e-6)
    np.testing.assert_allclose(v.grad.numpy(), vf.grad.numpy(), atol=1e-6)


def test_wrapper_rejects_other_devices():
    """A device that is neither the CPU nor CUDA raises; a ``meta`` tensor
    (the dry-run's shapes, ``launch.dryrun``) takes the blockwise plain
    version and gives q's shape on ``meta``."""
    from repro_torch.kernels import is_cpu

    class OtherDevice:
        device = torch.device("xpu")
    with pytest.raises(ValueError, match="unsupported device"):
        is_cpu(OtherDevice())
    _, (q, k, v) = _inputs(7, 1, 8, 2, 1, 32)
    out = flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert out.device.type == "meta" and out.shape == q.shape


# head dims 16 to 256 (B, S, H, KV, D, causal, window, Skv), heads and S cut:
# causal calls, windows, ragged S and non-causal calls with Skv != Sq
HEAD_DIM_CASES = [
    (1, 256, 4, 2, 16, True, None, None),
    (1, 300, 4, 4, 36, True, 64, None),
    (1, 200, 4, 2, 48, False, None, 150),
    (1, 256, 4, 1, 112, True, None, None),
    (1, 300, 4, 2, 160, True, 100, None),
    (1, 200, 4, 4, 192, False, None, 77),
    (1, 256, 4, 1, 224, True, None, None),
    (1, 256, 4, 1, 256, True, None, None),      # Gemma's head dim
]


# ---- the bf16 tensor-core kernel's numerics, emulated on the CPU -----------
def _sm90_emulated(q, k, v, *, causal, window):
    """What ``csrc/flash_attention_sm90.cu`` computes, in float32 torch ops:
    CTAs of 128 query rows, two warpgroups of 64, key tiles of BK (128 for
    D <= 64, else 64) from the CTA's first visible tile (every tile when
    some row sees no key), a warpgroup skipping the tiles wholly above its
    diagonal or before its window; S = Q K^T in fp32 times 1/sqrt(D);
    masked scores -1e30, keys past Skv (zero-filled by the TMA) -inf;
    online softmax with exp2((s - m) log2 e); l sums the fp32 P, and
    O += bf16(P) V in fp32; o = O / max(l, 1e-30) in bf16. The kernel
    computes on DP = D rounded up to 32 columns, the TMA zero-filling D..DP-1
    of Q, K and V (the wrapper's padding to a multiple of 8 adds zeros
    alike; the scale stays 1/sqrt(D)), with key tiles of BK = 128 at DP <=
    64, 64 up to 160 and 32 above, and stores D."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    DP = -(-D // 32) * 32                                       # padded width
    BK = 128 if DP <= 64 else 64 if DP <= 160 else 32
    n_kt = -(-Skv // BK)
    pad = n_kt * BK - Skv
    qf = torch.nn.functional.pad(q.float(), (0, DP - D)).permute(0, 2, 1, 3)
    kf, vf = (torch.nn.functional.pad(t.float(), (0, DP - D, 0, 0, 0, pad))
              .permute(0, 2, 1, 3).repeat_interleave(H // KV, dim=1)
              for t in (k, v))                                  # [B,H,n_kt*BK,DP]
    scale, log2e = 1.0 / math.sqrt(D), 1.4426950408889634
    out = torch.zeros(B, H, Sq, DP)
    for q0 in range(0, Sq, 128):
        q_last = min(q0 + 128, Sq) - 1
        orphans = window is not None and q_last >= Skv - 1 + window
        k_end = min(Skv, q_last + 1) if causal else Skv
        k_begin = max(0, q0 - window + 1) if window and not orphans else 0
        k_begin = k_begin // BK * BK
        for r_lo in (q0, q0 + 64):
            if r_lo >= Sq:
                continue
            rows = torch.arange(r_lo, r_lo + 64)
            m = torch.full((B, H, 64), -1e30)
            l = torch.zeros(B, H, 64)
            o = torch.zeros(B, H, 64, DP)
            qt = torch.nn.functional.pad(qf[:, :, r_lo:r_lo + 64],
                                         (0, 0, 0, 64 - qf[:, :, r_lo:r_lo + 64].shape[2]))
            for k0 in range(k_begin, k_end, BK):
                if not orphans and ((causal and k0 > r_lo + 63) or (
                        window and k0 + BK - 1 < r_lo - window + 1)):
                    continue
                keys = torch.arange(k0, k0 + BK)
                s = (qt @ kf[:, :, k0:k0 + BK].transpose(-1, -2)) * scale
                vis = torch.ones(64, BK, dtype=torch.bool)
                if causal:
                    vis &= keys[None, :] <= rows[:, None]
                if window:
                    vis &= rows[:, None] - keys[None, :] < window
                s = torch.where(vis, s, -1e30)
                s = torch.where(keys[None, :] >= Skv, -math.inf, s)
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp2((m - m_new) * log2e)
                p = torch.exp2((s - m_new[..., None]) * log2e)
                l = l * corr + p.sum(-1)
                o = o * corr[..., None] + p.bfloat16().float() @ vf[:, :, k0:k0 + BK]
                m = m_new
            n = min(64, Sq - r_lo)
            out[:, :, r_lo:r_lo + n] = (o / torch.clamp(l, min=1e-30)[..., None])[:, :, :n]
    assert not out[..., D:].any()                # the padded columns stay zero
    return out[..., :D].permute(0, 2, 1, 3).to(torch.bfloat16)


@pytest.mark.parametrize("B,S,H,KV,D,causal,window,Skv", [
    (1, 2048, 8, 1, 64, True, None, None),     # the serve call, heads cut
    (1, 2048, 8, 1, 64, True, 256, None),
    (1, 1000, 8, 1, 64, True, None, None),     # ragged tiles
    (1, 2048, 4, 1, 32, True, None, None),
    (1, 2048, 8, 1, 128, True, None, None),
    (1, 300, 8, 2, 128, False, None, 333),     # Skv != Sq, past-Skv keys
    (1, 2048, 4, 1, 128, True, 1024, None),    # mixtral's call (half-S window), cut
    (1, 300, 8, 2, 128, True, 77, None),       # a window ending inside a key tile
    (1, 200, 4, 1, 64, False, 50, 77),         # rows that see no key
    (1, 2048, 4, 4, 80, True, None, None),     # zamba2's serve call, cut
    (1, 2048, 4, 2, 80, True, 256, None),      # D = 80 with a window
    (1, 2048, 4, 4, 96, True, None, None),     # phi-3-vision's head dim
    (1, 1000, 4, 2, 96, True, None, None),     # D = 96, ragged S
    # whisper's cross-attention, G = 1, heads and S cut: non-causal, a
    # ragged last key tile (150 = 128 + 22; 1500 = 11 x 128 + 92)
    (1, 256, 6, 6, 64, False, None, 150),
    (1, 256, 6, 6, 64, False, None, 1500),
    *HEAD_DIM_CASES,
])
def test_sm90_numerics_emulated_fit_the_bf16_gate(B, S, H, KV, D, causal,
                                                   window, Skv):
    """The bf16 FLASH_CASES of ``chip_smoke.py`` (batch and heads cut, the
    card's unit-variance inputs), emulated as the tensor-core kernel
    computes them, against the plain version (fp32 P) and, where its tiling
    applies, the interpreted Pallas kernel, or else (non-causal) the JAX
    package's oracle: within the unchanged 2e-2."""
    Skv = Skv or S
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(torch.bfloat16)
               for shape in ((B, S, H, D), (B, Skv, KV, D), (B, Skv, KV, D)))
    got = _sm90_emulated(q, k, v, causal=causal, window=window)
    want = attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2, rtol=0)
    if causal and Skv == S and S % 256 == 0:
        jq, jk, jv = (jnp.asarray(t.float().numpy()).astype("bfloat16")
                      for t in (q, k, v))
        pallas = flash_attention_pallas(jq, jk, jv, causal=True, window=window,
                                        interpret=True)
        np.testing.assert_allclose(_f32(got), _f32(pallas), atol=2e-2, rtol=0)
    if not causal:
        oracle = j_attention_ref(*(jnp.asarray(t.float().numpy()).astype("bfloat16")
                                   for t in (q, k, v)), causal=False, window=window)
        np.testing.assert_allclose(_f32(got), _f32(oracle), atol=2e-2, rtol=0)


# ---- the fp32 SIMT kernel's numerics, modelled on the CPU ------------------
def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf(a, b, c) in float32: the product is exact in float64, and the
    sum is rounded once more to float32 (a double rounding that fmaf does
    not do; it moves a result by an ulp at most, and rarely)."""
    return (a.double() * b.double() + c.double()).float()


def _simt_f32_emulated(q, k, v, *, causal, window):
    """What ``csrc/flash_attention.cu`` computes up to a head dim of 128, in
    torch ops: CTAs of 64 query rows, key tiles of BK (64 for D = 32, else
    32) from the CTA's
    first tile that can hold a visible key (every tile when some row sees
    none) to its last; q times 1/sqrt(D) in fp32; each score a chain of
    fmaf over d in order; masked scores -1e30, keys past Skv -inf; a row's
    max over the tile and one rescale a tile; l held as 8 shares (share tx
    sums the tile's keys tx + 8 i in order, then is added to its rescaled
    self) added at the end in the shuffles' tree; O rescaled, then a chain
    of fmaf over the tile's keys in order; o = O / max(l, 1e-30). The
    rows of K and V in shared memory hold DP = D rounded up to 32 columns,
    D..DP-1 zero-filled: each score sums d = 0..D-1 only, O's padded
    columns stay zero and D are stored."""
    B, Sq, H, D = q.shape
    DP = -(-D // 32) * 32                                       # padded width
    assert DP <= ops.SIMT_MAX
    BQ = 64                                                     # rows a CTA
    Skv, KV = k.shape[1], k.shape[2]
    BK = 64 if D <= 32 else 32
    n_kt = -(-Skv // BK)
    pad = n_kt * BK - Skv
    scale = torch.tensor(1.0 / D ** 0.5, dtype=torch.float32)
    qf = (q.float() * scale).permute(0, 2, 1, 3)                # [B,H,Sq,D]
    kf, vf = (torch.nn.functional.pad(t.float(), (0, DP - D, 0, 0, 0, pad))
              .permute(0, 2, 1, 3).repeat_interleave(H // KV, dim=1)
              for t in (k, v))                                  # [B,H,n_kt*BK,DP]
    out = torch.zeros(B, H, Sq, DP)
    for q0 in range(0, Sq, BQ):
        q_last = min(q0 + BQ, Sq) - 1
        k_end = min(Skv, q_last + 1) if causal else Skv
        k_begin = (max(0, q0 - window + 1)
                   if window and q_last < Skv - 1 + window else 0)
        k_begin = k_begin // BK * BK
        rows = torch.arange(q0, q0 + BQ)
        qt = torch.nn.functional.pad(qf[:, :, q0:q0 + BQ],
                                     (0, 0, 0, BQ - qf[:, :, q0:q0 + BQ].shape[2]))
        m = torch.full((B, H, BQ), -1e30)
        shares = torch.zeros(B, H, BQ, 8)
        acc = torch.zeros(B, H, BQ, DP)
        for k0 in range(k_begin, k_end, BK):
            keys = torch.arange(k0, k0 + BK)
            kt, vt = kf[:, :, k0:k0 + BK], vf[:, :, k0:k0 + BK]
            s = torch.zeros(B, H, BQ, BK)
            for d in range(D):
                s = _fma(qt[..., d, None], kt[..., None, :, d], s)
            vis = torch.ones(BQ, BK, dtype=torch.bool)
            if causal:
                vis &= keys[None, :] <= rows[:, None]
            if window:
                vis &= rows[:, None] - keys[None, :] < window
            s = torch.where(vis, s, -1e30)
            s = torch.where(keys[None, :] >= Skv, -math.inf, s)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            own = torch.zeros(B, H, BQ, 8)
            for i in range(BK // 8):
                own = own + p[..., 8 * i:8 * i + 8]
            shares = shares * corr[..., None] + own
            acc = acc * corr[..., None]
            for j in range(BK):
                acc = _fma(p[..., j, None], vt[:, :, None, j], acc)
            m = m_new
        a = shares[..., 0::2] + shares[..., 1::2]           # xor 1
        b = a[..., 0::2] + a[..., 1::2]                      # xor 2
        l = b[..., 0] + b[..., 1]                            # xor 4
        n = min(BQ, Sq - q0)
        out[:, :, q0:q0 + n] = (acc / torch.clamp(l, min=1e-30)[..., None])[:, :, :n]
    assert not out[..., D:].any()                # the padded columns stay zero
    return out[..., :D].permute(0, 2, 1, 3)


@pytest.mark.parametrize("B,S,H,KV,D,causal,window,Skv", [
    (1, 256, 8, 1, 64, True, None, None),      # the serve call, cut
    (1, 200, 8, 2, 64, True, 100, None),       # a window, ragged tiles
    (1, 256, 4, 2, 32, True, None, None),      # phase 6's call, cut
    (1, 300, 8, 2, 128, True, 77, None),       # D = 128
    (1, 200, 4, 1, 64, False, 50, 77),         # rows that see no key
    (1, 256, 4, 4, 80, True, None, None),      # zamba2's call, cut
    (1, 200, 4, 2, 80, True, 64, None),        # D = 80 with a window
    (1, 256, 4, 4, 96, True, None, None),      # D = 96
    (1, 130, 4, 2, 96, False, None, 150),      # D = 96, Skv != Sq
    (1, 256, 6, 6, 64, False, None, 150),      # whisper's cross call, cut
    *HEAD_DIM_CASES,
])
def test_simt_f32_numerics_emulated_fit_the_fp32_gate(B, S, H, KV, D, causal,
                                                      window, Skv):
    """The fp32 FLASH_CASES of ``chip_smoke.py`` (S, batch and heads cut,
    the card's unit-variance inputs), modelled as the fp32 kernel of their
    head dim computes them (the SIMT kernel up to 128, the 3xTF32 one
    above), against the plain version and the JAX package's oracle: within
    the card's unchanged fp32 gate, 1e-5."""
    Skv = Skv or S
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((B, S, H, D), (B, Skv, KV, D), (B, Skv, KV, D)))
    if ops.f32_route(-(-D // 4) * 4) == "simt":
        got = _simt_f32_emulated(q, k, v, causal=causal, window=window)
    else:
        got, _ = tf32_model(q, k, v, causal=causal, window=window)
    want = attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5, rtol=0)
    oracle = j_attention_ref(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                             causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), _f32(oracle), atol=1e-5, rtol=0)
