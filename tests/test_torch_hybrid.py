"""The port's hybrid family (zamba2: Mamba2 layers and one shared
attention block every ``attn_every`` of them) against the JAX package.

The smoke model's forward, prefill, decode steps and caches (per-layer
Mamba2 conv tails and states, one ring KV cache a group) at
``test_torch_lm``'s ATOL (2e-4) in fp32 and 0.05 in bf16; a prefill of
2,048 tokens at ``head_dim=80`` (zamba2's), which takes the flash branch
(the kernel's plain version here) in both packages; the port's prefill
and decode against its own forward; the serving copy, names, specs,
``generate()`` and the serve CLI. Weights come from the JAX package's
init through ``repro_torch.convert``; every JAX call runs under
``jax.threefry_partitionable(False)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtfm
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import serve, steps
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm
from test_torch_lm import ATOL, _models, _np, _reference_serve_flow, _tokens

ARCH = "zamba2-2.7b"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one intra-op thread: the suite runs several
    workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check_caches(cache, want, atol, rel=False, k_atol=None):
    """Per-layer Mamba2 caches and per-group KV caches against the JAX
    package's stacked ones: within ``atol`` (the keys within ``k_atol``
    when given), or with ``rel`` within ``atol`` of each tensor's scale."""
    assert len(cache["layers"]) == np.asarray(want["layers"]["state"]).shape[0]
    assert len(cache["shared_attn"]) == np.asarray(want["shared_attn"]["k"]).shape[0]
    pairs = [(n, np.stack([_np(c[n]) for c in cache["layers"]]), _np(want["layers"][n]))
             for n in ("conv", "state")]
    pairs += [(n, np.stack([_np(c[n]) for c in cache["shared_attn"]]),
               _np(want["shared_attn"][n])) for n in ("k", "v")]
    for n, got, w in pairs:
        tol = atol * np.abs(w).max() if rel else atol
        if n == "k" and k_atol is not None:
            tol = k_atol
        np.testing.assert_allclose(got, w, atol=tol, rtol=0, err_msg=n)
    got = np.stack([_np(c["slot_pos"]) for c in cache["shared_attn"]])
    np.testing.assert_array_equal(got, np.asarray(want["shared_attn"]["slot_pos"]))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def reference_run(request):
    """One JAX run a dtype of the zamba2 smoke model (4 Mamba2 layers, the
    shared block every 2): forward over 20 tokens, prefill of 16, 4 decode
    steps, and the final caches."""
    dtype = request.param
    jcfg, params, cfg, model = _models(ARCH, dtype=dtype)
    S, T = 16, 4
    toks = _tokens((2, S + T), cfg.vocab_size, seed=41)
    with jax.threefry_partitionable(False):
        full, _ = jtfm.lm_forward(params, jnp.asarray(toks), jcfg)
        lg, cache = jtfm.lm_prefill(params, jnp.asarray(toks[:, :S]), jcfg,
                                    cache_len=S + T)
        steps_lg = [lg]
        for t in range(S, S + T):
            lg, cache = jtfm.lm_decode(params, jnp.asarray(toks[:, t:t + 1]), cache,
                                       jnp.int32(t), jcfg)
            steps_lg.append(lg)
    return dict(dtype=dtype, cfg=cfg, model=model, toks=toks, S=S, T=T,
                full=_np(full), steps=[_np(x) for x in steps_lg],
                cache=jax.device_get(cache))


def test_forward_prefill_decode_and_caches_match_the_reference(reference_run):
    """fp32 at ATOL; bf16 logits at 0.05 (``test_torch_lm``'s bf16 bound)
    and caches at 5% of each one's scale (``chip_smoke.py``'s bf16 rule:
    five blocks of bf16 activations, rounded at other points by the two
    frameworks, move the later layers' conv tails, states and K/V by up
    to ~2% of their scale)."""
    r = reference_run
    cfg, model, toks, S, T = r["cfg"], r["model"], torch.from_numpy(r["toks"]), r["S"], r["T"]
    atol = ATOL if r["dtype"] == "float32" else 0.05
    with torch.no_grad():
        full, aux = ttfm.lm_forward(model, toks, cfg)
        lg, cache = ttfm.lm_prefill(model, toks[:, :S], cfg, cache_len=S + T)
        got = [lg]
        for t in range(S, S + T):
            lg, cache = ttfm.lm_decode(model, toks[:, t:t + 1], cache, t, cfg)
            got.append(lg)
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(full), r["full"], atol=atol, rtol=0)
    for g, w in zip(got, r["steps"]):
        np.testing.assert_allclose(_np(g), w, atol=atol, rtol=0)
    if r["dtype"] == "float32":
        _check_caches(cache, r["cache"], ATOL)
    else:
        _check_caches(cache, r["cache"], 0.05, rel=True)


def test_prefill_at_the_flash_threshold_with_head_dim_80(monkeypatch):
    """2,048 tokens at zamba2's head_dim 80: the shared block takes the
    flash branch in both packages (the JAX package's chunked scan, the
    port's wrapper), once a group; last logits and caches at ATOL but the
    rotated keys at 5e-4. Inside its scanned prefill the JAX package's
    RoPE frequencies are a constant that XLA folds in float64 (rounded
    once); the port computes them in float32 as the JAX package's eager
    ``rope_freqs`` does (``test_torch_lm`` holds the port to that at 1e-5).
    At head_dim 80 a dozen of the 40 frequencies differ by an ulp, which
    2,047 positions turn into up to ~4e-4 of a key of size ~4 (the dense
    model's keys at head_dim 64 stay within ATOL: ``test_torch_lm``)."""
    jcfg, params, cfg, model = _models(ARCH, head_dim=80)
    S = 2048
    toks = _tokens((1, S), cfg.vocab_size, seed=42)
    with jax.threefry_partitionable(False):
        jlg, jcache = jtfm.lm_prefill(params, jnp.asarray(toks), jcfg, cache_len=S + 1)
    calls = []
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **kw: calls.append(a[0].shape) or flash_attention(*a, **kw))
    with torch.no_grad():
        lg, cache = ttfm.lm_prefill(model, torch.from_numpy(toks), cfg, cache_len=S + 1)
    assert calls == [(1, S, cfg.n_heads, 80)] * (cfg.n_layers // cfg.attn_every)
    np.testing.assert_allclose(_np(lg), _np(jlg), atol=ATOL, rtol=0)
    _check_caches(cache, jax.device_get(jcache), ATOL, k_atol=5e-4)


def test_prefill_then_decode_continues_the_ports_own_forward():
    _, _, cfg, model = _models(ARCH)
    S, T = 16, 4
    toks = torch.from_numpy(_tokens((2, S + T), cfg.vocab_size, seed=43))
    with torch.no_grad():
        full, _ = ttfm.lm_forward(model, toks, cfg)
        lg, cache = ttfm.lm_prefill(model, toks[:, :S], cfg, cache_len=S + T)
        np.testing.assert_allclose(_np(lg[:, 0]), _np(full[:, S - 1]), atol=ATOL, rtol=0)
        for t in range(S, S + T):
            lg, cache = ttfm.lm_decode(model, toks[:, t:t + 1], cache, t, cfg)
            np.testing.assert_allclose(_np(lg[:, 0]), _np(full[:, t]), atol=ATOL, rtol=0)


def test_remat_forward_under_grad_equals_the_plain_forward():
    """cfg.remat under grad checkpoints each Mamba2 layer and the shared
    block once a group: the same loss and gradients as without remat."""
    _, _, cfg, model = _models(ARCH)
    toks = torch.from_numpy(_tokens((2, 16), cfg.vocab_size, seed=44))
    losses, grads = [], []
    for remat in (True, False):
        model.zero_grad()
        loss, _ = ttfm.lm_loss(model, {"tokens": toks}, cfg.replace(remat=remat))
        loss.backward()
        losses.append(loss.detach())
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    assert torch.equal(losses[0], losses[1])
    for n in grads[0]:
        torch.testing.assert_close(grads[0][n], grads[1][n], rtol=0, atol=1e-7)
    assert grads[0]["shared_attn.attn.wq.w"].abs().sum() > 0


def test_serving_copy_names_and_specs():
    cfg = tconfigs.get_smoke(ARCH)                               # bf16
    model = ttfm.LM(cfg, torch.Generator().manual_seed(0))
    fast = ttfm.for_compute(model, cfg)
    m = fast.layers[0].mamba
    assert m.in_proj.w.dtype == m.out_proj.w.dtype == torch.bfloat16
    assert fast.shared_attn.mlp.gate.w.dtype == torch.bfloat16
    for p in (m.conv_w, m.conv_b, m.A_log, m.dt_bias, m.D, m.norm.scale,
              fast.layers[0].ln.scale, fast.lm_head.table):
        assert p.dtype == torch.float32
    toks = torch.from_numpy(_tokens((1, 16), cfg.vocab_size, seed=45))
    with torch.no_grad():
        assert torch.equal(ttfm.lm_forward(fast, toks, cfg)[0],
                           ttfm.lm_forward(model, toks, cfg)[0])

    jcfg, params, scfg, smodel = _models(ARCH)
    conv = lm_params_from_numpy(jax.device_get(params), scfg, device="cpu")
    assert sorted(conv) == sorted(n for n, _ in smodel.named_parameters())
    full = tconfigs.get_config(ARCH)
    spec = steps.input_specs(ARCH, "decode_32k")
    assert len(spec["cache"]["layers"]) == 54 and len(spec["cache"]["shared_attn"]) == 9
    assert spec["cache"]["layers"][0]["state"].shape == (128, 80, 64, 64)
    assert spec["cache"]["layers"][0]["conv"].shape == (128, 3, 5120 + 128)
    assert spec["cache"]["shared_attn"][0]["k"].shape == (128, 32768, 32, 80)
    p = steps.params_shape(full)
    assert 2.3e9 < sum(t.numel() for t in p.values()) < 2.6e9


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_generate_reproduces_the_reference_serve_flow(temperature):
    prompt_len, gen, batch = 16, 5, 2
    params, prompt, want, last = _reference_serve_flow(
        ARCH, "float32", prompt_len, gen, batch, temperature)
    cfg = tconfigs.get_smoke(ARCH).replace(dtype="float32")
    model = ttfm.LM(cfg)
    model.load_state_dict(lm_params_from_numpy(jax.device_get(params), cfg,
                                               device="cpu"))
    out = serve.generate(cfg, model, prompt_len=prompt_len, gen=gen, batch=batch,
                         temperature=temperature, seed=0, device="cpu")
    np.testing.assert_array_equal(out.prompt.numpy(), prompt)
    np.testing.assert_array_equal(out.ids.numpy(), want)
    np.testing.assert_allclose(_np(out.decode_logits[-1]), last, atol=ATOL, rtol=0)


def test_serve_cli_runs_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--prompt-len", "8",
                "--gen", "3", "--batch", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"{ARCH}: prefill 8 tok in ")
    assert "decoded 3 tok" in lines[0]
