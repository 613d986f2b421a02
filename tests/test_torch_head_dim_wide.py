"""Head dims above 256 (ROADMAP B-8g) against the JAX package.

The reference's Pallas flash kernel takes any D; the port's kernels take
D > 256 by cutting O into column groups (one a CTA; ``csrc/flash_sm90.cuh``,
``csrc/flash_tf32.cuh``, ``csrc/flash_split.cuh``). Here, on the CPU:

* the plain versions (``attention_ref`` serving, ``flash_fwd_ref`` under
  grad) against the interpreted Pallas kernel at D = 264, 300, 320 and 512
  in fp32, bf16 and fp16 (fp32 atol 2e-6, as the JAX package holds its own
  kernel; the 16-bit types 2e-2, the bf16 bound of ``tests/test_kernels.py``);
* a CPU model of the 16-bit tensor-core kernel's column groups and D
  chunks (``tests/torch_flash_models.py``; fp32 from 257 to 2,048 takes the
  3xTF32 cluster kernel, ``test_torch_flash_tf32.py``, and past the
  clusters both types the split route, ``test_torch_flash_split.py``)
  against the plain version and the JAX package's oracle, at the card's
  gate (2e-2): every group's running max and sum are equal, bit for bit;
* the smoke TinyLlama at ``head_dim=512`` against the reference at 2,048
  tokens (the flash branch): the forward's logits and one train step's
  gradients, as ``test_torch_head_dim.py`` holds D = 256 (and for the
  same reason against the reference's eager form).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.models import transformer as jtfm
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
from repro_torch.launch import train
from repro_torch.models import transformer as ttfm
from torch_flash_models import sm90_model

TOL = {"float32": 2e-6, "bfloat16": 2e-2, "float16": 2e-2}
ARCH, HEAD_DIM, SEQ = "tinyllama-1.1b", 512, 2048


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one intra-op thread: the suite runs several
    workers on the machine's cores, and a process with a thread a core
    each slows all of them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, Sq, H, KV, D, Skv=None, dtype="float32", scale=0.3):
    rng = np.random.default_rng(seed)
    Skv = Skv or Sq
    arrays = [(rng.standard_normal(s) * scale).astype(np.float32)
              for s in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D))]
    jt = [jnp.asarray(a).astype(dtype) for a in arrays]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jt, tt


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("D", [264, 300, 320, 512])
def test_plain_versions_match_the_pallas_kernel_past_256(dtype, D):
    """The interpreted Pallas kernel (causal, a window of 50) against the
    serving plain version and the chunked one under grad, within TOL."""
    (jq, jk, jv), (q, k, v) = _inputs(D, 1, 128, 4, 2, D, dtype=dtype)
    with jax.threefry_partitionable(False):
        want = flash_attention_pallas(jq, jk, jv, causal=True, window=50,
                                      interpret=True)
    got = flash_attention(q, k, v, causal=True, window=50)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype], rtol=0)
    chunked, _ = flash_fwd_ref(q, k, v, causal=True, window=50)
    np.testing.assert_allclose(_f32(chunked), _f32(want), atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("B,S,H,KV,D,causal,window,Skv", [
    (1, 256, 2, 1, 264, True, None, None),      # 2 groups of 160, ragged chunk
    (1, 200, 2, 1, 320, True, 77, None),        # a window, ragged query tile
    (1, 160, 2, 1, 300, False, None, 150),      # cross: Skv != Sq; D padded to 304
    (1, 256, 2, 1, 512, True, None, None),      # 3 groups of 192
    (1, 130, 1, 1, 1000, False, 50, 77),        # 5 groups of 224; rows with no key
])
def test_sm90_column_groups_fit_the_16_bit_gate(dtype, B, S, H, KV, D, causal,
                                                window, Skv):
    """The tensor-core kernel's groups and chunks, modelled: within 2e-2 of
    the plain version and of the JAX oracle; each group's m and l equal."""
    _, (q, k, v) = _inputs(11, B, S, H, KV, D, Skv=Skv, dtype=dtype, scale=1.0)
    record = []
    got = sm90_model(q, k, v, causal=causal, window=window, record=record)
    ng = ops.column_groups(-(-D // 8) * 8, q.dtype)[0]
    assert ng >= 2 and {r[0] for r in record} == set(range(ng))
    by_tile = {}
    for g, q0, r_lo, m, l in record:
        by_tile.setdefault((q0, r_lo), []).append((m, l))
    for stats in by_tile.values():
        assert len(stats) == ng
        for m, l in stats[1:]:
            assert torch.equal(m, stats[0][0]) and torch.equal(l, stats[0][1])
    want = attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2, rtol=0)
    oracle = j_attention_ref(*(jnp.asarray(t.float().numpy()).astype(dtype)
                               for t in (q, k, v)), causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), _f32(oracle), atol=2e-2, rtol=0)


# ---- the smoke TinyLlama at head_dim 512 ---------------------------------
@pytest.fixture(scope="module")
def one_layer():
    """Both packages' smoke TinyLlama at head_dim 512, cut to one of its two
    layers (the reference's eager backward at D = 512 is slow), with the
    same weights."""
    jcfg = jconfigs.get_smoke(ARCH).replace(dtype="float32", head_dim=HEAD_DIM,
                                            n_layers=1)
    cfg = tconfigs.get_smoke(ARCH).replace(dtype="float32", head_dim=HEAD_DIM,
                                           n_layers=1)
    assert cfg.resolved_head_dim == jcfg.resolved_head_dim == HEAD_DIM
    with jax.threefry_partitionable(False):
        params = jtfm.init_lm(jax.random.PRNGKey(0), jcfg)
    model = ttfm.LM(cfg)
    model.load_state_dict(lm_params_from_numpy(jax.device_get(params), cfg,
                                               device="cpu"))
    return jcfg, params, cfg, model


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float64)
    return out


def test_forward_at_2048_tokens_matches_the_reference(one_layer):
    """One 2,048-token forward on the flash branch at D = 512: logits within
    2e-4 of the reference's (the JAX package's prefill-against-forward
    bound)."""
    jcfg, params, cfg, model = one_layer
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, SEQ)).astype(np.int32)
    with jax.threefry_partitionable(False):
        want = jtfm.lm_forward(params, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        got = ttfm.lm_forward(model, torch.from_numpy(toks), cfg)
    want = want[0] if isinstance(want, tuple) else want
    got = got[0] if isinstance(got, tuple) else got
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2e-4, rtol=0)


def test_train_step_gradients_match_the_reference(one_layer):
    """One train step's loss and gradients at S = 2,048, D = 512 (batch 1,
    one layer): the port's Function on the CPU (``flash_fwd_ref`` forward,
    one ``flash_bwd_ref`` call) against ``jax.grad`` of the eager
    reference's loss: the loss rtol 1e-5, each leaf within 1e-5 of its
    scale."""
    jcfg, params, cfg, model = one_layer
    batch = next(iter(train.make_lm_batches(cfg, 1, SEQ, 1, device="cpu")))
    jbatch = {"tokens": jnp.asarray(batch["tokens"].numpy())}
    with jax.threefry_partitionable(False), jax.disable_jit():
        jloss, jgrads = jax.value_and_grad(
            lambda p: jtfm.lm_loss(p, jbatch, jcfg)[0])(params)
    calls = ops.flash_attention.backward_calls
    loss, _ = ttfm.lm_loss(model, batch, cfg)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert ops.flash_attention.backward_calls - calls == cfg.n_layers
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    got = _flat(lm_params_to_numpy(
        dict(zip([n for n, _ in model.named_parameters()], grads)), cfg))
    want = _flat(jax.device_get(jgrads))
    assert sorted(got) == sorted(want)
    errs = {k: float(np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-30))
            for k in want}
    assert max(errs.values()) <= 1e-5, errs
