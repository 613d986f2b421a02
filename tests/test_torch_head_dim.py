"""The smoke TinyLlama at head_dim 256 (Gemma-2B's and Gemma-7B's head dim,
arXiv:2403.08295) against the JAX package, on the flash branch.

No config of either package has that head dim, so both are built from the
smoke config with ``replace(head_dim=256)`` (q, k and v project to 8 and 2
heads of 256 from d_model 256). At 2,048 tokens both packages take the
flash branch: the port's plain versions on the CPU (``attention_ref`` for
the forward, ``flash_fwd_ref``/``flash_bwd_ref`` under grad), the
reference's ``_flash_fwd_impl`` and its custom VJP. The reference runs
eagerly here, op by op: at D = 256 the jitted reference folds RoPE's 128
frequencies with other roundings than its eager form, a few of them an ulp
apart from the port's (ROADMAP C-21), and the eager form is the one whose
float32 operations the port repeats. Gates: logits atol 2e-4 (the JAX
package's prefill-against-forward bound), the first gradients within 1e-5
of each leaf's scale, the loss rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtfm
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import train
from repro_torch.models import transformer as ttfm

ARCH, HEAD_DIM, SEQ = "tinyllama-1.1b", 256, 2048


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one intra-op thread: the suite runs several
    workers on the machine's cores, and a process with a thread a core
    each slows all of them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(**replace):
    jcfg = jconfigs.get_smoke(ARCH).replace(dtype="float32", head_dim=HEAD_DIM,
                                            **replace)
    cfg = tconfigs.get_smoke(ARCH).replace(dtype="float32", head_dim=HEAD_DIM,
                                           **replace)
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


def test_forward_at_2048_tokens_matches_the_reference():
    """One 2,048-token forward on the flash branch: logits within 2e-4 of
    the eager reference's."""
    jcfg, params, cfg, model = _pair()
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, SEQ)).astype(np.int32)
    with jax.threefry_partitionable(False):
        want = jtfm.lm_forward(params, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        got = ttfm.lm_forward(model, torch.from_numpy(toks), cfg)
    want = want[0] if isinstance(want, tuple) else want
    got = got[0] if isinstance(got, tuple) else got
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2e-4, rtol=0)


def test_train_step_gradients_match_the_reference():
    """One train step's loss and gradients at S = 2,048 (batch 1, one of the
    smoke model's two layers: the reference's eager backward is slow): the
    port's Function on the CPU (``flash_fwd_ref`` forward, one
    ``flash_bwd_ref`` call a layer) against ``jax.grad`` of the eager
    reference's loss: the loss rtol 1e-5, each leaf within 1e-5 of its
    scale. (Against the reference run without ``disable_jit``, whose
    scans and remat compile, wq's and wk's gradients lie 1.3e-5 and 1.4e-5
    of their scale apart at batch 2: C-21.)"""
    jcfg, params, cfg, model = _pair(n_layers=1)
    batch = next(iter(train.make_lm_batches(cfg, 1, SEQ, 1, device="cpu")))
    jbatch = {"tokens": jnp.asarray(batch["tokens"].numpy())}
    with jax.threefry_partitionable(False), jax.disable_jit():
        jloss, jgrads = jax.value_and_grad(
            lambda p: jtfm.lm_loss(p, jbatch, jcfg)[0])(params)
    calls = flash_ops.flash_attention.backward_calls
    loss, _ = ttfm.lm_loss(model, batch, cfg)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert flash_ops.flash_attention.backward_calls - calls == cfg.n_layers
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    got = _flat(lm_params_to_numpy(
        dict(zip([n for n, _ in model.named_parameters()], grads)), cfg))
    want = _flat(jax.device_get(jgrads))
    assert sorted(got) == sorted(want)
    errs = {k: float(np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-30))
            for k in want}
    assert max(errs.values()) <= 1e-5, errs
