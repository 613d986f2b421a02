"""The port's dense LM serving path against the JAX package.

Configs field for field; the layers; both branches of
``attention_forward``; ``lm_forward``, ``lm_prefill`` and ``lm_decode``
with their caches; and the serve flow (``launch.serve.generate`` against
the lines of ``repro.launch.serve.main``). Weights come from the JAX
package's init through ``repro_torch.convert.lm_params_from_numpy``; every
JAX call runs under ``jax.threefry_partitionable(False)``.

Tolerances: fp32 logits and caches atol 2e-4, the JAX package's own
prefill-against-forward bound (``tests/test_decode.py``); the layers in fp32
atol 1e-5 (one pass of float32 roundings in other orders). In bf16 the two
frameworks round at the same points but compute some ops (silu, the
matmul's output rounding) differently, so bf16 results are held to a few
bf16 ulps of their scale (stated per test).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import serve, steps
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm

ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one intra-op thread: the suite runs several
    workers on the machine's cores, and a process with a thread a core
    each slows all of them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _models(arch, dtype="float32", seed=0, **replace):
    """The JAX package's params and the port's LM with the same weights."""
    jcfg = jconfigs.get_smoke(arch).replace(dtype=dtype, **replace)
    cfg = tconfigs.get_smoke(arch).replace(dtype=dtype, **replace)
    with jax.threefry_partitionable(False):
        params = jtfm.init_lm(jax.random.PRNGKey(seed), jcfg)
    model = ttfm.LM(cfg)
    model.load_state_dict(lm_params_from_numpy(jax.device_get(params), cfg,
                                               device="cpu"))
    return jcfg, params, cfg, model


def _tokens(shape, vocab, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _stack_cache(cache) -> dict:
    return {n: np.stack([_np(c[n]) for c in cache["layers"]])
            for n in ("k", "v", "slot_pos")}


# -------------------------------------------------------------- configs ----
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS + ["fmnist-cnn"])
def test_every_config_field_matches_the_reference(arch):
    for getter in ("get_config", "get_smoke"):
        want = getattr(jconfigs, getter)(arch)
        got = getattr(tconfigs, getter)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (arch, getter)
        assert got.resolved_head_dim == want.resolved_head_dim
        assert got.is_attention_free == want.is_attention_free


def test_registry_and_shapes_match_the_reference():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert ([f.name for f in dataclasses.fields(tconfigs.ModelConfig)]
            == [f.name for f in dataclasses.fields(jconfigs.ModelConfig)])
    assert ({k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()})
    for arch in jconfigs.ARCH_IDS:
        cfg = jconfigs.get_config(arch)
        for shape in jconfigs.SHAPES.values():
            assert (steps.cache_len_for(tconfigs.get_config(arch), shape)
                    == jsteps.cache_len_for(cfg, shape))


# --------------------------------------------------------------- layers ----
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 1.6e-2)])
def test_rmsnorm_rope_and_swiglu_match_the_reference(dtype, atol):
    """bf16: each result is one bf16 rounding of an fp32 value of order 1
    (an ulp is 2^-7 = 7.8e-3 at 1..2), so two ulps."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 4, 32)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))

    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-5)
    got = tlayers.rmsnorm(torch.from_numpy(scale), tx, 1e-5)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)

    np.testing.assert_allclose(_np(tlayers.rope_freqs(32, 1e4)),
                               _np(jlayers.rope_freqs(32, 1e4)), rtol=1e-6)
    for pos in (np.arange(12), np.arange(40, 52)[None].repeat(2, 0)):
        want = jlayers.apply_rope(jx, jnp.asarray(pos), 1e4)
        got = tlayers.apply_rope(tx, torch.from_numpy(pos), 1e4)
        assert got.dtype == tx.dtype
        np.testing.assert_allclose(_np(got), _np(want), atol=atol * 4, rtol=0)

    with jax.threefry_partitionable(False):
        jp = jlayers.swiglu_init(jax.random.PRNGKey(3), 32, 64)
    mlp = tlayers.SwiGLU(32, 64)
    mlp.load_state_dict({f"{n}.w": torch.tensor(np.asarray(jp[n]["w"]))
                         for n in ("gate", "up", "down")})
    want = jlayers.swiglu(jp, jx)
    got = tlayers.swiglu(mlp, tx)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


# ------------------------------------------------------------ attention ----
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "glm4-9b"])
@pytest.mark.parametrize("S,window", [(24, None), (24, 5), (2048, None), (2048, 300)])
def test_attention_forward_both_branches(arch, S, window):
    """S = 24 takes the direct branch in both packages; S = 2048 the JAX
    package's chunked flash scan and the port's flash wrapper (its plain
    version here). The returned K/V are the cache's input."""
    jcfg, params, cfg, model = _models(arch)
    x = np.random.default_rng(2).standard_normal((1, S, cfg.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda t: t[0], params["layers"]["attn"])
    want, (jk, jv) = jattn.attention_forward(jp, jnp.asarray(x), jcfg, window=window,
                                             return_kv=True)
    before = flash_attention.launches
    with torch.no_grad():
        got, (k, v) = tattn.attention_forward(model.layers[0].attn, torch.from_numpy(x),
                                              cfg, window=window, return_kv=True)
    assert flash_attention.launches == before          # the CPU runs no kernel
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(k), _np(jk), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(v), _np(jv), atol=1e-5, rtol=0)


def test_flash_branch_is_taken_at_the_reference_threshold(monkeypatch):
    _, _, cfg, model = _models("tinyllama-1.1b")
    calls = []
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **kw: calls.append(a[0].shape) or flash_attention(*a, **kw))
    for S in (2047, 2048, 2049, 2053):     # 2053 is prime: no chunk, direct
        x = torch.zeros(1, S, cfg.d_model)
        with torch.no_grad():
            tattn.attention_forward(model.layers[0].attn, x, cfg)
    assert [c[1] for c in calls] == [2048, 2049]
    assert jattn._chunk_of(2053, 1024) == tattn._chunk_of(2053, 1024) == 1


# ------------------------------------------------------------------ LM ----
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "glm4-9b"])
def test_forward_prefill_and_decode_match_the_reference(arch):
    jcfg, params, cfg, model = _models(arch)
    S, T = 16, 4
    toks = _tokens((2, S + T), cfg.vocab_size)
    want, _ = jtfm.lm_forward(params, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        got, aux = ttfm.lm_forward(model, torch.from_numpy(toks), cfg)
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)

    jlg, jcache = jtfm.lm_prefill(params, jnp.asarray(toks[:, :S]), jcfg, cache_len=32)
    with torch.no_grad():
        lg, cache = ttfm.lm_prefill(model, torch.from_numpy(toks[:, :S]), cfg, cache_len=32)
    np.testing.assert_allclose(_np(lg), _np(jlg), atol=ATOL, rtol=0)
    for t in range(S, S + T):
        jlg, jcache = jtfm.lm_decode(params, jnp.asarray(toks[:, t:t + 1]), jcache,
                                     jnp.int32(t), jcfg)
        with torch.no_grad():
            lg, cache = ttfm.lm_decode(model, torch.from_numpy(toks[:, t:t + 1]),
                                       cache, t, cfg)
        np.testing.assert_allclose(_np(lg), _np(jlg), atol=ATOL, rtol=0)
    got_c = _stack_cache(cache)
    for n in ("k", "v"):
        np.testing.assert_allclose(got_c[n], _np(jcache["layers"][n]), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got_c["slot_pos"], np.asarray(jcache["layers"]["slot_pos"]))


def test_prefill_at_the_flash_threshold_matches_the_reference():
    """A 2048-token prompt: the JAX package's flash scan against the port's
    flash wrapper, then two decode steps against the ring cache."""
    jcfg, params, cfg, model = _models("tinyllama-1.1b")
    S = 2048
    toks = _tokens((1, S + 2), cfg.vocab_size, seed=4)
    jlg, jcache = jtfm.lm_prefill(params, jnp.asarray(toks[:, :S]), jcfg, cache_len=S + 2)
    with torch.no_grad():
        lg, cache = ttfm.lm_prefill(model, torch.from_numpy(toks[:, :S]), cfg,
                                    cache_len=S + 2)
    np.testing.assert_allclose(_np(lg), _np(jlg), atol=ATOL, rtol=0)
    for t in (S, S + 1):
        jlg, jcache = jtfm.lm_decode(params, jnp.asarray(toks[:, t:t + 1]), jcache,
                                     jnp.int32(t), jcfg)
        with torch.no_grad():
            lg, cache = ttfm.lm_decode(model, torch.from_numpy(toks[:, t:t + 1]),
                                       cache, t, cfg)
        np.testing.assert_allclose(_np(lg), _np(jlg), atol=ATOL, rtol=0)
    got_c = _stack_cache(cache)
    np.testing.assert_allclose(got_c["k"], _np(jcache["layers"]["k"]), atol=ATOL, rtol=0)


def test_bf16_forward_and_decode_match_the_reference():
    """bf16 (the configs' compute type): logits of order 1 after two layers
    whose activations are rounded to bf16 at the same points in both
    packages; the frameworks' bf16 matmuls and silu round differently, so
    the logits agree to 0.05 (a few bf16 ulps of the residual stream,
    carried through the fp32 head)."""
    jcfg, params, cfg, model = _models("tinyllama-1.1b", dtype="bfloat16")
    toks = _tokens((2, 18), cfg.vocab_size, seed=5)
    want, _ = jtfm.lm_forward(params, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        got, _ = ttfm.lm_forward(model, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(_np(got), _np(want), atol=0.05, rtol=0)
    jlg, jcache = jtfm.lm_prefill(params, jnp.asarray(toks[:, :16]), jcfg, cache_len=18)
    jlg, _ = jtfm.lm_decode(params, jnp.asarray(toks[:, 16:17]), jcache, jnp.int32(16), jcfg)
    with torch.no_grad():
        lg, cache = ttfm.lm_prefill(model, torch.from_numpy(toks[:, :16]), cfg, cache_len=18)
        lg, _ = ttfm.lm_decode(model, torch.from_numpy(toks[:, 16:17]), cache, 16, cfg)
    np.testing.assert_allclose(_np(lg), _np(jlg), atol=0.05, rtol=0)


@pytest.mark.parametrize("window", [None, 8])
def test_prefill_then_decode_continues_the_ports_own_forward(window):
    """The port against itself, as ``tests/test_decode.py`` holds the JAX
    package: prefill's last logits and each decode step equal the full
    forward's at that position (a ring cache of ``window`` slots)."""
    _, _, cfg, model = _models("tinyllama-1.1b", sliding_window=window)
    S, T = 16, 6
    toks = torch.from_numpy(_tokens((2, S + T), cfg.vocab_size, seed=6))
    with torch.no_grad():
        full, _ = ttfm.lm_forward(model, toks, cfg)
        lg, cache = ttfm.lm_prefill(model, toks[:, :S], cfg, cache_len=window or S + T)
        np.testing.assert_allclose(_np(lg[:, 0]), _np(full[:, S - 1]), atol=ATOL, rtol=0)
        for t in range(S, S + T):
            lg, cache = ttfm.lm_decode(model, toks[:, t:t + 1], cache, t, cfg)
            np.testing.assert_allclose(_np(lg[:, 0]), _np(full[:, t]), atol=ATOL, rtol=0)


def test_serving_copy_has_the_per_call_cast_bits():
    _, _, cfg, model = _models("glm4-9b", dtype="bfloat16")
    fast = ttfm.for_compute(model, cfg)
    assert fast.layers[0].attn.wq.w.dtype == torch.bfloat16
    assert fast.layers[0].attn.wq.b.dtype == torch.bfloat16
    assert fast.embed.table.dtype == torch.bfloat16
    assert fast.lm_head.table.dtype == torch.float32
    assert fast.layers[0].ln1.scale.dtype == torch.float32
    assert model.layers[0].attn.wq.w.dtype == torch.float32      # master untouched
    toks = torch.from_numpy(_tokens((1, 12), cfg.vocab_size, seed=7))
    with torch.no_grad():
        assert torch.equal(ttfm.lm_forward(fast, toks, cfg)[0],
                           ttfm.lm_forward(model, toks, cfg)[0])
    f32 = cfg.replace(dtype="float32")
    assert ttfm.for_compute(model, f32) is model
    assert ttfm.for_compute(fast, cfg) is fast
    # the other families: leaves cast per call in the JAX package are bf16
    # in the copy, the rest fp32, and the copy computes the same bits
    for arch, cast, kept in (
            ("qwen2-moe-a2.7b", ("moe.w_gate", "moe.w_up", "moe.w_down",
                                 "moe.shared.gate.w", "attn.wq.b"),
             ("moe.router.w", "ln2.scale")),
            ("rwkv6-1.6b", ("time.wr.w", "ffn.wv.w"),
             ("time.mu", "time.w0", "time.wA", "time.wB", "time.u", "ln1.bias")),
            ("zamba2-2.7b", ("mamba.in_proj.w", "mamba.out_proj.w"),
             ("mamba.conv_w", "mamba.conv_b", "mamba.A_log", "mamba.dt_bias",
              "mamba.D", "mamba.norm.scale"))):
        fcfg = tconfigs.get_smoke(arch)
        master = ttfm.LM(fcfg, torch.Generator().manual_seed(0))
        copy = dict(ttfm.for_compute(master, fcfg).named_parameters())
        for n in cast:
            assert copy[f"layers.0.{n}"].dtype == torch.bfloat16, (arch, n)
        for n in kept:
            assert copy[f"layers.0.{n}"].dtype == torch.float32, (arch, n)
        assert copy["embed.table"].dtype == torch.bfloat16
        assert copy["lm_head.table"].dtype == torch.float32
        assert dict(master.named_parameters())["embed.table"].dtype == torch.float32
        toks = torch.from_numpy(_tokens((1, 12), fcfg.vocab_size, seed=7))
        with torch.no_grad():
            assert torch.equal(ttfm.lm_forward(ttfm.for_compute(master, fcfg), toks,
                                               fcfg)[0],
                               ttfm.lm_forward(master, toks, fcfg)[0]), arch


def test_an_unknown_family_raises():
    """Every family of the configs is ported; another one raises
    ``ValueError``, as the JAX package's ``init_lm`` does."""
    for arch in tconfigs.ARCH_IDS:
        ttfm.check_family(tconfigs.get_smoke(arch))
    cfg = tconfigs.get_smoke("tinyllama-1.1b").replace(family="retnet")
    for call in (ttfm.check_family, ttfm.LM, steps.init_for, steps.loss_for,
                 lambda c: ttfm.init_lm_cache(c, 1, 8)):
        with pytest.raises(ValueError, match="retnet"):
            call(cfg)
    with pytest.raises(ValueError, match="encoder-decoder"):
        ttfm.init_lm_cache(tconfigs.get_smoke("whisper-tiny"), 1, 8)


def test_converted_names_are_the_modules_parameters():
    jcfg, params, cfg, model = _models("glm4-9b")
    conv = lm_params_from_numpy(jax.device_get(params), cfg, device="cpu")
    assert sorted(conv) == sorted(n for n, _ in model.named_parameters())
    with pytest.raises(ValueError, match="layers"):
        lm_params_from_numpy(jax.device_get(params), cfg.replace(n_layers=3),
                             device="cpu")


def test_step_builders_run_prefill_and_decode():
    _, _, cfg, model = _models("tinyllama-1.1b")
    shape = tconfigs.ShapeConfig("tiny", 12, 2, "prefill")
    toks = torch.from_numpy(_tokens((2, 12), cfg.vocab_size, seed=8))
    with torch.no_grad():
        lg, cache = steps.build_prefill_step(cfg, shape)(model, {"tokens": toks})
        want, _ = ttfm.lm_prefill(model, toks, cfg, cache_len=12)
        assert torch.equal(lg, want) and cache["layers"][0]["k"].shape[1] == 12
        lg2, _ = steps.build_serve_step(cfg)(model, cache, toks[:, -1:], 12)
    assert lg2.shape == (2, 1, cfg.vocab_size)
    gen = torch.Generator().manual_seed(0)
    assert isinstance(steps.init_for(cfg)(gen), ttfm.LM)
    cnn_cfg = tconfigs.get_smoke("fmnist-cnn")
    assert steps.init_for(cnn_cfg)(gen).fc2.w.shape == (cnn_cfg.cnn_dense, 10)


# ---------------------------------------------------------------- serve ----
def _reference_serve_flow(arch, dtype, prompt_len, gen, batch, temperature):
    """The lines of ``repro.launch.serve.main`` for the dense family."""
    cfg = jconfigs.get_smoke(arch).replace(dtype=dtype)
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(0)
        params = jsteps.init_for(cfg)(key)
        cache_len = prompt_len + gen
        prompt = jax.random.randint(key, (batch, prompt_len), 0, cfg.vocab_size)
        logits, cache = jtfm.lm_prefill(params, prompt, cfg, cache_len=cache_len)
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        toks = [tok]
        for i in range(gen):
            logits, cache = jtfm.lm_decode(params, tok, cache, jnp.int32(prompt_len + i), cfg)
            if temperature > 0:
                key, sk = jax.random.split(key)
                tok = jax.random.categorical(
                    sk, logits[:, -1] / temperature)[:, None].astype(jnp.int32)
            else:
                tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
            toks.append(tok)
    out = np.concatenate([np.asarray(t) for t in toks], axis=1)
    return params, np.asarray(prompt), out, np.asarray(logits[:, -1])


@pytest.mark.parametrize("dtype,atol", [("float32", ATOL), ("bfloat16", 0.05)])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_generate_reproduces_the_reference_serve_flow(temperature, dtype, atol):
    """Equal prompt ids and sampled ids (the first one the prefill's
    argmax); the last step's logits to the fp32 / bf16 bound above."""
    arch, prompt_len, gen, batch = "tinyllama-1.1b", 16, 6, 3
    params, prompt, want, last = _reference_serve_flow(
        arch, dtype, prompt_len, gen, batch, temperature)
    cfg = tconfigs.get_smoke(arch).replace(dtype=dtype)
    model = ttfm.LM(cfg)
    model.load_state_dict(lm_params_from_numpy(jax.device_get(params), cfg,
                                               device="cpu"))
    out = serve.generate(cfg, model, prompt_len=prompt_len, gen=gen, batch=batch,
                         temperature=temperature, seed=0, device="cpu")
    np.testing.assert_array_equal(out.prompt.numpy(), prompt)
    np.testing.assert_array_equal(out.ids.numpy(), want)
    assert len(out.decode_logits) == gen
    np.testing.assert_allclose(_np(out.decode_logits[-1]), last, atol=atol, rtol=0)


def test_serve_cli_runs_on_the_cpu(capsys):
    serve.main(["--arch", "tinyllama-1.1b", "--smoke", "--prompt-len", "8",
                "--gen", "3", "--batch", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("tinyllama-1.1b: prefill 8 tok in ")
    assert "decoded 3 tok" in lines[0] and lines[1].startswith("sampled ids (first request):")
