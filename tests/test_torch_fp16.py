"""float16 through the port (ROADMAP B-8h) and the flash wrapper's grid rule
(C-30), against the JAX package.

Both packages list ``"float16"`` as a model dtype. On the card an fp16
prefill reaches the tensor-core flash kernel's fp16 instances
(``csrc/flash_attention_sm90_f16.cu``: wgmma .f16, P and o rounded to
fp16) and the cross-silo exchange's block top-k its fp16 lanes
(``csrc/topk_block.cu``, dtype code 2). Here, on the CPU:

* the smoke TinyLlama in fp16 against the reference: logits within 5% of
  their scale, the bf16 serving bound (ROADMAP C-10), on the direct branch
  and at 2,048 tokens on the flash branch;
* the flash wrapper routes fp16 to its own entry and counter, and on CPU
  tensors runs the plain version (serving and under grad) with no launch
  counted;
* the fp16 plain block top-k against the reference's interpreted Pallas
  kernel, bit for bit (dropped lanes +0.0, ROADMAP C-11), with fp16's
  subnormals (normal in fp32: compared by value, not as zero) and NaNs;
* the tensor-core kernel's numerics in fp16 (``tests/torch_flash_models.py``:
  P rounded to fp16 before P V) within the 16-bit gate, 2e-2;
* ``ops.check_grid``: B * H on grid x up to 2^31 - 1 (the wrapper refused
  B * H > 65,535 before), the query tiles on y, the column groups on z.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.topk_sparsify.ops import block_topk_sparsify as j_pallas
from repro.models import transformer as jtfm
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.topk_sparsify import block_topk_sparsify
from repro_torch.kernels.topk_sparsify import ops as topk_ops
from repro_torch.models import transformer as ttfm
from torch_flash_models import sm90_model

ARCH = "tinyllama-1.1b"
SERVE_REL_TOL = 0.05


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one intra-op thread: the suite runs several
    workers on the machine's cores, and a process with a thread a core
    each slows all of them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("seq", [64, 2048])
def test_smoke_tinyllama_in_fp16_matches_the_reference(seq):
    """lm_forward in fp16 from the reference's weights: logits within 5% of
    their scale (C-10's serving bound); at 2,048 tokens both packages take
    the flash branch (the port's ``attention_ref`` on the CPU)."""
    jcfg = jconfigs.get_smoke(ARCH).replace(dtype="float16")
    cfg = tconfigs.get_smoke(ARCH).replace(dtype="float16")
    with jax.threefry_partitionable(False):
        params = jtfm.init_lm(jax.random.PRNGKey(0), jcfg)
    model = ttfm.LM(cfg)
    model.load_state_dict(lm_params_from_numpy(jax.device_get(params), cfg,
                                               device="cpu"))
    model = ttfm.for_compute(model, cfg)
    assert model.layers[0].attn.wq.w.dtype == torch.float16
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, seq)).astype(np.int32)
    with jax.threefry_partitionable(False):
        want = jtfm.lm_forward(params, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        got = ttfm.lm_forward(model, torch.from_numpy(toks), cfg)
    want = _f32(want[0] if isinstance(want, tuple) else want)
    got = _f32(got[0] if isinstance(got, tuple) else got)
    assert np.isfinite(got).all()
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= SERVE_REL_TOL * scale


def test_wrapper_routes_fp16_and_counts_no_launch_on_the_cpu():
    """fp16 has its own C entry, attributes entry and counter, the bf16
    entry's signature and 16-byte rows of 8 columns; on CPU tensors the
    wrapper runs the plain version, serving and under grad, and counts no
    launch."""
    assert ops._ROUTES[torch.float16] == ("flash_attention_fwd_f16",
                                          "flash_attention_attrs_f16",
                                          "launches_f16")
    assert ops.ROW_MULTIPLE[torch.float16] == 8
    assert (_build.SIGNATURES["flash_attention_fwd_f16"]
            == _build.SIGNATURES["flash_attention_fwd_bf16"])
    assert (_build.SIGNATURES["flash_attention_attrs_f16"]
            == _build.SIGNATURES["flash_attention_attrs_bf16"])
    assert topk_ops._DTYPE_CODES[torch.float16] == 2
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).half()
               for s in ((1, 40, 4, 64), (1, 40, 2, 64), (1, 40, 2, 64)))
    fa = ops.flash_attention
    before = (fa.launches, fa.launches_f16, fa.launches_lse)
    got = flash_attention(q, k, v, causal=True, window=16)
    assert got.dtype == torch.float16
    assert torch.equal(got, attention_ref(q, k, v, causal=True, window=16))
    calls = fa.backward_calls
    qg = q.clone().requires_grad_(True)
    out = flash_attention(qg, k, v, causal=True)
    out.float().square().sum().backward()
    assert fa.backward_calls == calls + 1
    assert qg.grad.dtype == torch.float16 and bool(torch.isfinite(qg.grad).all())
    assert (fa.launches, fa.launches_f16, fa.launches_lse) == before


def _fp16_tricky(n=2 * 4096 + 300, seed=4) -> np.ndarray:
    """fp16 bit patterns: normals, NaN, +-Inf, -0.0, ties, a run of one
    value, fp16 subnormals (both signs), a signalling NaN and the all-ones
    NaN 0x7fff."""
    rng = np.random.default_rng(seed)
    v = (rng.normal(size=n) * 0.1).astype(np.float16)
    v[::7] = np.nan
    v[1::11] = np.inf
    v[2::13] = -np.inf
    v[3::5] = -0.0
    v[4096:4096 + 900] = np.round(v[4096:4096 + 900] * 20) / 20      # ties
    v[4096 + 1000:4096 + 1400] = -0.75
    bits = v.view(np.uint16)
    sub = rng.integers(1, 1024, size=n // 6).astype(np.uint16)
    sign = (rng.integers(0, 2, size=n // 6) << 15).astype(np.uint16)
    bits[5::6][:n // 6] = sub | sign
    bits[8] = 0x7C01                 # signalling NaN
    bits[9] = 0x7FFF                 # every mantissa bit set
    bits[6000:6400] = rng.integers(1, 1024, size=400).astype(np.uint16)
    return v


@pytest.mark.parametrize("gamma,block", [(0.1, 4096), (0.25, 1024), (0.5, 256),
                                         (1.0, 4096), (0.02, 2048)])
def test_fp16_block_topk_matches_the_pallas_kernel(gamma, block):
    """The plain version (the CPU side of the card's fp16 lanes) against the
    interpreted Pallas kernel bit for bit, fp16 in its own type: dropped
    lanes +0.0, fp16 subnormals kept or dropped by value (they widen to
    normal fp32 numbers, so the denormals-as-zero compare of C-16 does not
    touch them)."""
    x = _fp16_tricky()
    got, k = block_topk_sparsify(torch.from_numpy(x.view(np.int16)).view(torch.float16),
                                 gamma, block=block)
    with jax.threefry_partitionable(False):
        want, k1 = j_pallas(jnp.asarray(x), gamma, block=block)
    assert k == k1 and got.dtype == torch.float16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    dropped = got.view(torch.int16).numpy() == 0
    assert dropped.sum() >= x.size - -(-x.size // block) * k
    kept_sub = (~dropped) & ((x.view(np.uint16) & 0x7C00) == 0) & (x != 0)
    if gamma >= 0.5:
        assert kept_sub.any()        # subnormals compared by value, not as zero


@pytest.mark.parametrize("B,S,H,KV,D,causal,window,Skv", [
    (1, 256, 4, 1, 64, True, None, None),      # the serve call, heads cut
    (1, 256, 4, 2, 80, True, 64, None),        # zamba2's head dim, a window
    (1, 200, 4, 2, 128, False, None, 150),     # cross: Skv != Sq
    (1, 256, 2, 1, 256, True, None, None),     # Gemma's head dim
])
def test_emulated_fp16_p_rounding_fits_the_16_bit_gate(B, S, H, KV, D, causal,
                                                       window, Skv):
    """The tensor-core kernel in fp16, modelled (P rounded to fp16 before
    P V, o rounded to fp16), within 2e-2 of the plain version (fp32 P) and,
    for the causal calls, of the interpreted Pallas kernel."""
    Skv = Skv or S
    rng = np.random.default_rng(D)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).half()
               for s in ((B, S, H, D), (B, Skv, KV, D), (B, Skv, KV, D)))
    got = sm90_model(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.float16
    want = attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2, rtol=0)
    if causal:
        with jax.threefry_partitionable(False):
            pallas = flash_attention_pallas(
                *(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=True,
                window=window, interpret=True)
        np.testing.assert_allclose(_f32(got), _f32(pallas), atol=2e-2, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_the_grid_rule_is_the_kernels_limits(dtype):
    """B * H is on grid x (both kernels: blockIdx.x = b H + h), up to 2^31 -
    1: B * H = 65,536 and 65,600 pass (the wrapper refused every B * H over
    65,535 before). The query tiles are on y, up to 65,535: 128 rows a tile
    on the tensor cores (fp32's 3xTF32 kernels from a padded width of 129
    and its split route past 2,048 among them), 64 on the SIMT kernel up to
    128. The column groups of a head dim above 256 are on z (the split
    route, which puts them on x, keeps the rule)."""
    ops.check_grid(1, 65536, 128, 32, dtype)
    ops.check_grid(2050, 32, 128, 32, dtype)
    with pytest.raises(ValueError, match="x limit"):
        ops.check_grid(2**16, 2**15, 128, 32, dtype)
    for D in (32, 128, 160, 256, 512, 2048, 4096):
        rows = ops.query_tile_rows(dtype, D)
        assert rows == (64 if dtype == torch.float32 and D <= 128 else 128)
        ops.check_grid(1, 1, 65535 * rows, D, dtype)
        with pytest.raises(ValueError, match="y limit"):
            ops.check_grid(1, 1, 65535 * rows + 1, D, dtype)
    cap = ops.GROUP_MAX[dtype]
    assert ops.column_groups(65535 * cap, dtype) == (65535, cap)
    ops.check_grid(1, 1, 128, 65535 * cap, dtype)
    with pytest.raises(ValueError, match="z limit"):
        ops.check_grid(1, 1, 128, 65535 * cap + 8, dtype)
    assert ops.MAX_HEAD_DIM == 65535 * 224
    for D in range(8, 4097, 8):
        ng, gw = ops.column_groups(D, dtype)
        if D <= 256:
            assert (ng, gw) == (1, D)
        else:
            assert gw in ops.WIDE_GROUP_WIDTHS[dtype] and (ng - 1) * gw < D <= ng * gw
