"""The port's attention-free layers (RWKV6, Mamba2) and the ssm family
(rwkv6) against the JAX package.

LayerNorm and the group norm; ``rwkv6_forward`` and ``mamba2_forward``
(chunked) with their prefill states and each step of ``rwkv6_decode`` /
``mamba2_decode`` against the JAX package's; the port's chunked forwards
against its own step-wise decode at chunk 8, as ``tests/test_decode.py``
holds the reference; the rwkv6 smoke model's forward, prefill, decode
steps and caches at ``test_torch_lm``'s ATOL (2e-4) in fp32 and 0.05 in
bf16; ``generate()`` and the serve CLI. Weights come from the JAX
package's init through ``repro_torch.convert``; every JAX call runs under
``jax.threefry_partitionable(False)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_numpy, params_from_numpy
from repro_torch.launch import serve, steps
from repro_torch.models import layers as tlayers
from repro_torch.models import rwkv as trwkv
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm
from test_torch_lm import ATOL, _models, _np, _reference_serve_flow, _tokens


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one intra-op thread: the suite runs several
    workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(module, tree: dict):
    """Load a JAX params subtree (one layer's) into a port module."""
    module.load_state_dict(params_from_numpy(tree, device="cpu"))
    return module


def _x(seed, B, S, d) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((B, S, d)) * 0.5
            ).astype(np.float32)


# ---------------------------------------------------------------- norms ----
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 1.6e-2)])
def test_layernorm_and_groupnorm_match_the_reference(dtype, atol):
    """bf16: one bf16 rounding of an fp32 value of order 1, two ulps."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 12, 64)) * 3 + 1).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    ln = tlayers.LayerNorm(64)
    ln.load_state_dict({"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = tlayers.layernorm(ln, tx, 1e-5)
    want = jlayers.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                             jx, 1e-5)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), atol=atol * 4, rtol=0)
    got = tlayers.groupnorm(tx, 4, 1e-5)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(jlayers.groupnorm(jx, 4, 1e-5)),
                               atol=atol * 4, rtol=0)


# ---------------------------------------------------------------- RWKV6 ----
def _rwkv(seed=0):
    cfg = jconfigs.get_smoke("rwkv6-1.6b").replace(dtype="float32")
    with jax.threefry_partitionable(False):
        jt = jrwkv.rwkv6_init(jax.random.PRNGKey(seed), cfg)
        jf = jrwkv.rwkv_ffn_init(jax.random.PRNGKey(seed + 1), cfg)
    tcfg = tconfigs.get_smoke("rwkv6-1.6b").replace(dtype="float32")
    time = _load(trwkv.RWKV6(tcfg), jax.device_get(jt))
    ffn = _load(trwkv.RWKVFFN(tcfg), jax.device_get(jf))
    return cfg, jt, jf, tcfg, time, ffn


@pytest.mark.parametrize("chunk", [8, 128])
def test_rwkv6_forward_state_and_decode_match_the_reference(chunk):
    """The chunked forward (32 tokens: 4 chunks of 8, or one of 32) and its
    prefill state; then 3 decode steps and the channel mix with its shift."""
    cfg, jt, jf, tcfg, time, ffn = _rwkv()
    x = _x(1, 2, 32, cfg.d_model)
    want, jst = jrwkv.rwkv6_forward(jt, jnp.asarray(x), cfg, chunk=chunk,
                                    return_state=True)
    with torch.no_grad():
        got, st = trwkv.rwkv6_forward(time, torch.from_numpy(x), tcfg, chunk=chunk,
                                      return_state=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(st["state"]), _np(jst["state"]), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(_np(st["shift"]), x[:, -1:])

    jc = dict(jst, ffn_shift=jnp.zeros((2, 1, cfg.d_model)))
    c = dict(st, ffn_shift=torch.zeros(2, 1, cfg.d_model))
    xs = _x(2, 2, 3, cfg.d_model)
    for t in range(3):
        jy, jc = jrwkv.rwkv6_decode(jt, jnp.asarray(xs[:, t:t + 1]), jc, cfg)
        with torch.no_grad():
            y, c = trwkv.rwkv6_decode(time, torch.from_numpy(xs[:, t:t + 1]), c, tcfg)
        np.testing.assert_allclose(_np(y), _np(jy), atol=1e-5, rtol=0)
        np.testing.assert_allclose(_np(c["state"]), _np(jc["state"]), atol=1e-5, rtol=0)
    prev = xs[:, :1]
    with torch.no_grad():
        got = trwkv.rwkv_ffn(ffn, torch.from_numpy(x), torch.from_numpy(prev))
    want = jrwkv.rwkv_ffn(jf, jnp.asarray(x), jnp.asarray(prev))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)


def test_rwkv6_chunked_equals_its_own_stepwise_decode():
    """As ``tests/test_decode.py`` holds the reference: chunk 8 over 32
    tokens against 32 decode steps, atol 1e-4."""
    _, _, _, tcfg, time, _ = _rwkv(seed=4)
    x = torch.from_numpy(_x(5, 2, 32, tcfg.d_model))
    with torch.no_grad():
        y_chunk = trwkv.rwkv6_forward(time, x, tcfg, chunk=8)
        cache = trwkv.make_rwkv_cache(tcfg, 2, torch.float32)
        ys = []
        for t in range(32):
            yt, cache = trwkv.rwkv6_decode(time, x[:, t:t + 1], cache, tcfg)
            ys.append(yt)
    np.testing.assert_allclose(_np(y_chunk), _np(torch.cat(ys, 1)), atol=1e-4, rtol=0)


# --------------------------------------------------------------- Mamba2 ----
def _mamba(seed=0):
    cfg = jconfigs.get_smoke("zamba2-2.7b").replace(dtype="float32", ssm_chunk=8)
    with jax.threefry_partitionable(False):
        jp = jssm.mamba2_init(jax.random.PRNGKey(seed), cfg)
    tcfg = tconfigs.get_smoke("zamba2-2.7b").replace(dtype="float32", ssm_chunk=8)
    return cfg, jp, tcfg, _load(tssm.Mamba2(tcfg), jax.device_get(jp))


@pytest.mark.parametrize("S", [32, 2])
def test_mamba2_forward_state_and_decode_match_the_reference(S):
    """The chunked forward (4 chunks of 8; S = 2 is one chunk shorter than
    the conv) with its conv tail and state; then 3 decode steps."""
    cfg, jp, tcfg, mamba = _mamba()
    x = _x(1, 2, S, cfg.d_model)
    want, jst = jssm.mamba2_forward(jp, jnp.asarray(x), cfg, return_state=True)
    with torch.no_grad():
        got, st = tssm.mamba2_forward(mamba, torch.from_numpy(x), tcfg, return_state=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(st["state"]), _np(jst["state"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(st["conv"]), _np(jst["conv"]), atol=1e-5, rtol=0)
    d_inner = tcfg.ssm_expand * tcfg.d_model
    assert st["conv"].shape == (2, tcfg.ssm_conv - 1, d_inner + 2 * tcfg.ssm_state)
    jc, c = jst, st
    xs = _x(2, 2, 3, cfg.d_model)
    for t in range(3):
        jy, jc = jssm.mamba2_decode(jp, jnp.asarray(xs[:, t:t + 1]), jc, cfg)
        with torch.no_grad():
            y, c = tssm.mamba2_decode(mamba, torch.from_numpy(xs[:, t:t + 1]), c, tcfg)
        np.testing.assert_allclose(_np(y), _np(jy), atol=1e-5, rtol=0)
        np.testing.assert_allclose(_np(c["state"]), _np(jc["state"]), atol=1e-5, rtol=0)
        np.testing.assert_allclose(_np(c["conv"]), _np(jc["conv"]), atol=1e-6, rtol=0)


def test_mamba2_chunked_equals_its_own_stepwise_decode():
    """As ``tests/test_decode.py`` holds the reference: chunk 8 over 32
    tokens against 32 decode steps, atol 1e-4."""
    _, _, tcfg, mamba = _mamba(seed=6)
    x = torch.from_numpy(_x(7, 2, 32, tcfg.d_model))
    with torch.no_grad():
        y_chunk = tssm.mamba2_forward(mamba, x, tcfg)
        cache = tssm.make_ssm_cache(tcfg, 2, torch.float32)
        ys = []
        for t in range(32):
            yt, cache = tssm.mamba2_decode(mamba, x[:, t:t + 1], cache, tcfg)
            ys.append(yt)
    np.testing.assert_allclose(_np(y_chunk), _np(torch.cat(ys, 1)), atol=1e-4, rtol=0)


# ---------------------------------------------------------- the rwkv6 LM ----
@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def reference_run(request):
    """One JAX run a dtype of the rwkv6 smoke model: forward over 256 + 4
    tokens' first 256 (two chunks of 128), prefill of 128, 4 decode steps,
    and the final caches."""
    dtype = request.param
    jcfg, params, cfg, model = _models("rwkv6-1.6b", dtype=dtype)
    S, T = 128, 4
    toks = _tokens((2, 256), cfg.vocab_size, seed=31)
    with jax.threefry_partitionable(False):
        full, _ = jtfm.lm_forward(params, jnp.asarray(toks), jcfg)
        lg, cache = jtfm.lm_prefill(params, jnp.asarray(toks[:, :S]), jcfg, cache_len=S)
        steps_lg = [lg]
        for t in range(S, S + T):
            lg, cache = jtfm.lm_decode(params, jnp.asarray(toks[:, t:t + 1]), cache,
                                       jnp.int32(t), jcfg)
            steps_lg.append(lg)
    return dict(dtype=dtype, cfg=cfg, model=model, toks=toks, S=S, T=T,
                full=_np(full), steps=[_np(x) for x in steps_lg],
                cache=jax.device_get(cache))


def test_rwkv6_model_forward_prefill_decode_and_caches_match_the_reference(
        reference_run):
    """fp32 at ATOL; bf16 at 0.05 (``test_torch_lm``'s bf16 bound), the
    bf16 run's fp32 states at 1% of their scale."""
    r = reference_run
    cfg, model, toks, S, T = r["cfg"], r["model"], torch.from_numpy(r["toks"]), r["S"], r["T"]
    atol = ATOL if r["dtype"] == "float32" else 0.05
    with torch.no_grad():
        full, aux = ttfm.lm_forward(model, toks, cfg)
        lg, cache = ttfm.lm_prefill(model, toks[:, :S], cfg, cache_len=S)
        got = [lg]
        for t in range(S, S + T):
            lg, cache = ttfm.lm_decode(model, toks[:, t:t + 1], cache, t, cfg)
            got.append(lg)
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(full), r["full"], atol=atol, rtol=0)
    for g, w in zip(got, r["steps"]):
        np.testing.assert_allclose(_np(g), w, atol=atol, rtol=0)
    want = r["cache"]["layers"]
    for n in ("shift", "ffn_shift", "state"):
        got_n, want_n = np.stack([_np(c[n]) for c in cache["layers"]]), _np(want[n])
        assert got_n.shape == want_n.shape
        tol = atol
        if n == "state" and r["dtype"] == "bfloat16":
            # fp32 sums over 128 steps of k v^T from bf16-rounded k and v,
            # rounded at other points by the two frameworks: the error
            # grows with the state (of order 100 here), so 1% of its scale
            tol = 1e-2 * np.abs(want_n).max()
        np.testing.assert_allclose(got_n, want_n, atol=tol, rtol=0)


def test_rwkv6_prefill_then_decode_continues_the_ports_own_forward():
    _, _, cfg, model = _models("rwkv6-1.6b")
    S, T = 16, 4
    toks = torch.from_numpy(_tokens((2, 32), cfg.vocab_size, seed=32))
    with torch.no_grad():
        full, _ = ttfm.lm_forward(model, toks, cfg)
        lg, cache = ttfm.lm_prefill(model, toks[:, :S], cfg, cache_len=S)
        np.testing.assert_allclose(_np(lg[:, 0]), _np(full[:, S - 1]), atol=ATOL, rtol=0)
        for t in range(S, S + T):
            lg, cache = ttfm.lm_decode(model, toks[:, t:t + 1], cache, t, cfg)
            np.testing.assert_allclose(_np(lg[:, 0]), _np(full[:, t]), atol=ATOL, rtol=0)


def test_rwkv6_serving_copy_keeps_the_recurrence_fp32():
    cfg = tconfigs.get_smoke("rwkv6-1.6b")                      # bf16
    model = ttfm.LM(cfg, torch.Generator().manual_seed(0))
    fast = ttfm.for_compute(model, cfg)
    layer = fast.layers[0]
    assert isinstance(fast.ln_f, tlayers.LayerNorm)
    assert layer.time.wr.w.dtype == layer.ffn.wk.w.dtype == torch.bfloat16
    for p in (layer.time.mu, layer.time.w0, layer.time.wA, layer.time.wB, layer.time.u,
              layer.ffn.mu, layer.ln1.bias, fast.ln_f.scale, fast.lm_head.table):
        assert p.dtype == torch.float32
    toks = torch.from_numpy(_tokens((1, 16), cfg.vocab_size, seed=33))
    with torch.no_grad():
        assert torch.equal(ttfm.lm_forward(fast, toks, cfg)[0],
                           ttfm.lm_forward(model, toks, cfg)[0])


def test_rwkv6_names_specs_and_steps():
    jcfg, params, cfg, model = _models("rwkv6-1.6b")
    conv = lm_params_from_numpy(jax.device_get(params), cfg, device="cpu")
    assert sorted(conv) == sorted(n for n, _ in model.named_parameters())
    spec = steps.input_specs("rwkv6-1.6b", "decode_32k")
    full = tconfigs.get_config("rwkv6-1.6b")
    c0 = spec["cache"]["layers"][0]
    assert len(spec["cache"]["layers"]) == full.n_layers
    assert c0["state"].shape == (128, 32, 64, 64) and c0["state"].dtype == torch.float32
    assert c0["shift"].shape == (128, 1, 2048) and c0["shift"].device.type == "meta"
    p = steps.params_shape(full)
    assert 1.5e9 < sum(t.numel() for t in p.values()) < 1.7e9


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_generate_reproduces_the_reference_serve_flow(temperature):
    arch, prompt_len, gen, batch = "rwkv6-1.6b", 16, 5, 2
    params, prompt, want, last = _reference_serve_flow(
        arch, "float32", prompt_len, gen, batch, temperature)
    cfg = tconfigs.get_smoke(arch).replace(dtype="float32")
    model = ttfm.LM(cfg)
    model.load_state_dict(lm_params_from_numpy(jax.device_get(params), cfg,
                                               device="cpu"))
    out = serve.generate(cfg, model, prompt_len=prompt_len, gen=gen, batch=batch,
                         temperature=temperature, seed=0, device="cpu")
    np.testing.assert_array_equal(out.prompt.numpy(), prompt)
    np.testing.assert_array_equal(out.ids.numpy(), want)
    np.testing.assert_allclose(_np(out.decode_logits[-1]), last, atol=ATOL, rtol=0)


def test_serve_cli_runs_on_the_cpu(capsys):
    serve.main(["--arch", "rwkv6-1.6b", "--smoke", "--prompt-len", "8",
                "--gen", "3", "--batch", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("rwkv6-1.6b: prefill 8 tok in ")
    assert "decoded 3 tok" in lines[0]
