"""The port's audio family (whisper: ``models.encdec``) against the JAX
package.

The GELU MLP and the sinusoidal table; cross-attention through both
branches (the flash branch at 2,048 decoder tokens against 64 frames,
non-causal, the kernel's plain version here) and the branch rule;
``make_cross_cache`` and ``cross_attention_decode``; ``encode``,
``decode_train``, ``encdec_loss`` and its gradients; the decode cache and
4 ``encdec_decode`` steps; ``serve.generate``'s audio flow against the
reference's ``serve.py`` flow rebuilt from its own functions; the step
builders, meta-device specs, converters, batches and CLIs. Weights come
from the JAX package's init through ``repro_torch.convert``; every JAX
call runs under ``jax.threefry_partitionable(False)``.

Tolerances (``test_torch_lm``'s): fp32 results within 1e-5 of their
scale (the largest magnitude of the reference's tensor: one pass of
float32 roundings in other orders), gradients within 1e-5 of each leaf's
scale; bf16 within 5% of the logits' scale (``chip_smoke.py``'s rule: the
frameworks round bf16 at other points); the sinusoidal table within one
float32 ulp of the reference's eager table.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.optim import adamw_init as j_adamw_init
from repro_torch import configs as tconfigs
from repro_torch.convert import (adamw_state_from_numpy, adamw_state_to_numpy,
                                 encdec_params_from_numpy, encdec_params_to_numpy,
                                 model_params_to_numpy)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve, steps, train
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tencdec
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm
from repro_torch.optim import adamw_init

ARCH = "whisper-tiny"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one intra-op thread: the suite runs several
    workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rel=1e-5, msg=""):
    """Within ``rel`` of the reference's scale."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape, msg)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()),
                               err_msg=msg)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _pair(dtype="float32", seed=0, **replace):
    """The JAX package's params and the port's EncDec with the same weights."""
    jcfg = jconfigs.get_smoke(ARCH).replace(dtype=dtype, **replace)
    cfg = tconfigs.get_smoke(ARCH).replace(dtype=dtype, **replace)
    with jax.threefry_partitionable(False):
        params = jencdec.init_encdec(jax.random.PRNGKey(seed), jcfg)
    model = tencdec.EncDec(cfg)
    model.load_state_dict(encdec_params_from_numpy(jax.device_get(params), cfg,
                                                   device="cpu"))
    return jcfg, params, cfg, model


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _inputs(cfg, B, T, seed=1):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    return frames, tokens


# --------------------------------------------------------------- layers ----
@pytest.mark.parametrize("dtype,rel", [("float32", 1e-5), ("bfloat16", 1.6e-2)])
def test_gelu_mlp_matches_the_reference(dtype, rel):
    """The tanh GELU (``jax.nn.gelu``'s default) between two biased dense
    layers, within ``rel`` of the output's scale; bf16 two ulps (2^-7
    each) of it, as test_torch_lm's layers."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    with jax.threefry_partitionable(False):
        jp = jlayers.gelu_mlp_init(jax.random.PRNGKey(3), 32, 64)
    for n, d in (("fc1", 64), ("fc2", 32)):                  # nonzero biases
        jp[n]["b"] = jnp.asarray(0.1 * rng.standard_normal(d).astype(np.float32))
    mlp = tlayers.GeluMLP(32, 64)
    mlp.load_state_dict({f"{n}.{w}": torch.tensor(np.asarray(jp[n][w]))
                         for n in ("fc1", "fc2") for w in ("w", "b")})
    jx, tx = jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    got = tlayers.gelu_mlp(mlp, tx)
    assert got.dtype == tx.dtype
    _close(got, jlayers.gelu_mlp(jp, jx), rel)


@pytest.mark.parametrize("n,d", [(64, 128), (1500, 384)])
def test_sinusoidal_positions_match_the_reference_eager_table(n, d):
    """The smoke and whisper-tiny tables against the reference's eager
    ``sinusoidal_positions``: the same powers of 10000 (XLA's ``powf``) and
    angles, so sin and cos agree to an ulp of their [-1, 1] values."""
    got = tlayers.sinusoidal_positions(n, d)
    want = np.asarray(jlayers.sinusoidal_positions(n, d))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1.2e-7, rtol=0)


def test_jitted_reference_table_folds_apart_c24():
    """ROADMAP C-24: inside a jit the reference's table is a constant that
    XLA folds (``pow`` and the angles at another precision), and at
    whisper-tiny's 1,500 frames x 384 it differs from the eager table (the
    port's) by up to 1.22e-4 (sin of angles up to 1,499 rad that moved by
    an ulp of the angle). Held here so that a change either way shows."""
    eager = np.asarray(jlayers.sinusoidal_positions(1500, 384))
    folded = np.asarray(jax.jit(lambda: jlayers.sinusoidal_positions(1500, 384))())
    diff = float(np.abs(folded - eager).max())
    assert 0.0 < diff <= 2.5e-4, diff
    port = tlayers.sinusoidal_positions(1500, 384).numpy()
    assert float(np.abs(port - eager).max()) <= 1.2e-7


# ------------------------------------------------------------ attention ----
@pytest.mark.parametrize("Sq,Skv", [(1500, 1500), (4096, 1500), (100, 1500),
                                    (32768, 1500), (2048, 64), (2047, 64),
                                    (24, 64), (2048, 2053), (2053, 64)])
def test_branch_rule_is_the_references(Sq, Skv):
    """``max(Sq, Skv) >= 2048`` and both lengths chunk (``_chunk_of`` > 1):
    whisper's encoder (1,500 frames) stays direct, a decoder of 4,096 or
    32,768 tokens against 1,500 frames takes the flash branch (chunk 750),
    one of 100 tokens the direct one."""
    want = (max(Sq, Skv) >= jattn._FLASH_THRESHOLD
            and jattn._chunk_of(Sq, jattn._Q_CHUNK) > 1
            and jattn._chunk_of(Skv, jattn._KV_CHUNK) > 1)
    assert tattn.uses_flash(Sq, Skv) == want


@pytest.mark.parametrize("Sq", [24, 2048])
def test_cross_attention_forward_both_branches(pair, monkeypatch, Sq):
    """Decoder states attending, non-causally and without RoPE, to 64
    encoder states: 24 rows take the direct branch in both packages, 2,048
    the flash branch (the JAX package's chunked scan; the port's wrapper,
    its plain version here). The returned K/V are the encoder's."""
    jcfg, params, cfg, model = pair
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, Sq, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda t: t[0], params["dec_layers"]["cross_attn"])
    want, (jk, jv) = jattn.attention_forward(jp, jnp.asarray(x), jcfg, causal=False,
                                             use_rope=False, kv_x=jnp.asarray(enc),
                                             return_kv=True)
    calls = []
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or flash_ops.flash_attention(*a, **kw))
    before = flash_ops.flash_attention.launches
    with torch.no_grad():
        got, (k, v) = tattn.attention_forward(
            model.dec_layers[0].cross_attn, torch.from_numpy(x), cfg, causal=False,
            use_rope=False, kv_x=torch.from_numpy(enc), return_kv=True)
    assert flash_ops.flash_attention.launches == before     # the CPU runs no kernel
    assert calls == ([{"causal": False, "window": None}] if Sq == 2048 else [])
    _close(got, want)
    _close(k, jk)
    _close(v, jv)


def test_flash_forward_and_backward_at_a_cross_shape_match_the_reference():
    """The training path's flash pieces at whisper's key length: 2,048
    queries against 1,500 keys (chunks of 1,024 rows and 750 keys),
    non-causal, G = 1 (heads and width cut): ``flash_fwd_ref``'s out and
    log-sum-exp against the reference's ``_flash_fwd_impl``, and
    ``FlashAttention``'s gradients (its CPU forward, ``flash_bwd_ref``)
    against ``jax.vjp`` of ``_flash_core`` (test_torch_train_flash's
    tolerances: out rtol 1e-5, lse 1e-5, gradients 1e-4 of their scale)."""
    B, Sq, Skv, H, D = 1, 2048, 1500, 2, 32
    rng = np.random.default_rng(7)
    q, dout = ((rng.standard_normal((B, Sq, H, D)) * 0.5).astype(np.float32)
               for _ in range(2))
    k, v = ((rng.standard_normal((B, Skv, H, D)) * 0.5).astype(np.float32)
            for _ in range(2))
    scale = 1.0 / D ** 0.5
    jq = jnp.asarray(q).reshape(B, Sq, H, 1, D)
    with jax.threefry_partitionable(False):
        jout, jlse = jattn._flash_fwd_impl(jq, jnp.asarray(k), jnp.asarray(v),
                                           scale=scale, causal=False, window=None)
        _, vjp = jax.vjp(lambda a, b, c: jattn._flash_core(scale, False, None, a, b, c),
                         jq, jnp.asarray(k), jnp.asarray(v))
        jgrads = vjp(jnp.asarray(dout).reshape(B, Sq, H, 1, D))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    calls = flash_ops.flash_attention.backward_calls
    out = flash_ops.flash_attention(*leaves, causal=False)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    assert flash_ops.flash_attention.backward_calls == calls + 1
    _, lse = flash_ops.flash_fwd_ref(*(t.detach() for t in leaves), causal=False)
    np.testing.assert_allclose(_np(out), np.asarray(jout).reshape(B, Sq, H, D),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-5, rtol=0)
    for name, g, w in zip(("dq", "dk", "dv"), grads, jgrads):
        _close(g, np.asarray(w).reshape(g.shape), 1e-4, msg=name)


def test_cross_cache_and_cross_decode_match_the_reference(pair):
    jcfg, params, cfg, model = pair
    rng = np.random.default_rng(3)
    enc = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda t: t[1], params["dec_layers"]["cross_attn"])
    jcross = jattn.make_cross_cache(jp, jnp.asarray(enc), jcfg)
    want = jattn.cross_attention_decode(jp, jnp.asarray(x), jcross, jcfg)
    layer = model.dec_layers[1].cross_attn
    with torch.no_grad():
        cross = tattn.make_cross_cache(layer, torch.from_numpy(enc), cfg)
        got = tattn.cross_attention_decode(layer, torch.from_numpy(x), cross, cfg)
    assert cross["k"].shape == (2, 64, cfg.n_kv_heads, cfg.resolved_head_dim)
    _close(cross["k"], jcross["k"])
    _close(cross["v"], jcross["v"])
    _close(got, want)


# ---------------------------------------------------------------- model ----
@pytest.fixture(scope="module")
def reference_run(pair):
    """The reference's encode, decode_train (all and last), loss (and with
    masked labels) and 4 decode steps from its cache, on 2 requests of 20
    tokens against 64 frames."""
    jcfg, params, cfg, model = pair
    frames, tokens = _inputs(cfg, 2, 20)
    with jax.threefry_partitionable(False):
        enc = jencdec.encode(params, jnp.asarray(frames), jcfg)
        logits = jencdec.decode_train(params, jnp.asarray(tokens), enc, jcfg)
        last = jencdec.decode_train(params, jnp.asarray(tokens), enc, jcfg,
                                    last_only=True)
        loss, _ = jencdec.encdec_loss(params, {"frames": jnp.asarray(frames),
                                               "tokens": jnp.asarray(tokens)}, jcfg)
        cache = jencdec.init_encdec_cache(params, enc, jcfg, 2, 8)
        decode = jax.jit(lambda p, t, c, i: jencdec.encdec_decode(p, t, c, i, jcfg))
        step_logits = []
        for t in range(4):
            lg, cache = decode(params, jnp.asarray(tokens[:, t:t + 1]), cache, jnp.int32(t))
            step_logits.append(np.asarray(lg))
    return dict(frames=frames, tokens=tokens, enc=np.asarray(enc),
                logits=np.asarray(logits), last=np.asarray(last), loss=float(loss),
                steps=step_logits, cache=jax.device_get(cache))


def test_encode_decode_train_and_loss_match_the_reference(pair, reference_run):
    jcfg, params, cfg, model = pair
    r = reference_run
    frames, tokens = torch.from_numpy(r["frames"]), torch.from_numpy(r["tokens"])
    with torch.no_grad():
        enc = tencdec.encode(model, frames, cfg)
        logits = tencdec.decode_train(model, tokens, enc, cfg)
        last = tencdec.decode_train(model, tokens, enc, cfg, last_only=True)
        loss, metrics = tencdec.encdec_loss(model, {"frames": frames, "tokens": tokens},
                                            cfg)
    _close(enc, r["enc"])
    _close(logits, r["logits"])
    _close(last, r["last"])
    assert last.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(float(loss), r["loss"], rtol=1e-5)
    assert float(metrics["xent"]) == float(loss)


def test_positions_wrap_at_max_target_len(pair):
    """The reference's shape exercise: decoder positions beyond
    ``max_target_len`` (64 in the smoke config) reuse the table mod its
    length, in both packages."""
    jcfg, params, cfg, model = pair
    pos = np.arange(0, 200, 7)
    want = jencdec._dec_positions(params, jnp.asarray(pos), jnp.float32)
    got = tencdec._dec_positions(model, torch.from_numpy(pos), torch.float32)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("T", [16, 2048])
def test_loss_gradients_match_the_reference(T):
    """``jax.grad`` of the reference's loss (remat on) against the port's
    backward: T = 16 through the direct branch, T = 2,048 through the flash
    branch in each decoder layer's causal self-attention and non-causal
    cross-attention (2,048 queries against 64 keys): the autograd
    Function's plain forward and ``flash_bwd_ref`` on the CPU, twice a
    layer."""
    jcfg, params, cfg, model = _pair(seed=1)
    frames, tokens = _inputs(cfg, 1, T, seed=4)
    batch = {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(tokens)}
    calls = flash_ops.flash_attention.backward_calls
    loss, _ = tencdec.encdec_loss(model, batch, cfg)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert flash_ops.flash_attention.backward_calls - calls == (
        2 * cfg.n_layers if T == 2048 else 0)
    with jax.threefry_partitionable(False):
        jloss, jg = jax.jit(jax.value_and_grad(lambda p, f, t: jencdec.encdec_loss(
            p, {"frames": f, "tokens": t}, jcfg)[0]))(
                params, jnp.asarray(frames), jnp.asarray(tokens))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    got = _flat(encdec_params_to_numpy(dict(zip(names, grads)), cfg))
    want = _flat(jax.device_get(jg))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], msg=k)


def test_decode_steps_and_per_layer_caches_match_the_reference(pair, reference_run):
    """``init_encdec_cache`` and 4 ``encdec_decode`` steps: each step's
    logits, the self caches (ring K/V and slot positions) and the cross
    K/V against the reference's stacked ones. Each decoder layer owns its
    self cache (the decode writes in place): the layers' keys differ. Each
    step also equals the port's own teacher-forced decoder at that
    position."""
    jcfg, params, cfg, model = pair
    r = reference_run
    tokens = torch.from_numpy(r["tokens"])
    with torch.no_grad():
        enc = tencdec.encode(model, torch.from_numpy(r["frames"]), cfg)
        full = tencdec.decode_train(model, tokens[:, :4], enc, cfg)
        cache = tencdec.init_encdec_cache(model, enc, cfg, 2, 8)
        ptrs = {c["k"].data_ptr() for c in cache["self"]}
        assert len(ptrs) == cfg.n_layers
        for t in range(4):
            lg, cache = tencdec.encdec_decode(model, tokens[:, t:t + 1], cache, t, cfg)
            _close(lg, r["steps"][t], msg=f"step {t}")
            _close(lg[:, 0], full[:, t], msg=f"step {t} against decode_train")
    want = r["cache"]
    for part, names in (("self", ("k", "v")), ("cross", ("k", "v"))):
        for n in names:
            _close(np.stack([_np(c[n]) for c in cache[part]]), want[part][n],
                   msg=f"{part}.{n}")
    np.testing.assert_array_equal(np.stack([c["slot_pos"].numpy() for c in cache["self"]]),
                                  np.asarray(want["self"]["slot_pos"]))
    assert not torch.equal(cache["self"][0]["k"], cache["self"][1]["k"])


def test_bf16_encode_decode_and_steps_within_five_percent():
    """bf16, the config's compute type: logits of the teacher-forced
    decoder and of 2 decode steps within 5% of their scale."""
    jcfg, params, cfg, model = _pair(dtype="bfloat16")
    frames, tokens = _inputs(cfg, 2, 12, seed=5)
    with jax.threefry_partitionable(False):
        jenc = jencdec.encode(params, jnp.asarray(frames), jcfg)
        want = jencdec.decode_train(params, jnp.asarray(tokens), jenc, jcfg)
        jc = jencdec.init_encdec_cache(params, jenc, jcfg, 2, 4)
        decode = jax.jit(lambda p, t, c, i: jencdec.encdec_decode(p, t, c, i, jcfg))
        jsteps_ = []
        for t in range(2):
            lg, jc = decode(params, jnp.asarray(tokens[:, t:t + 1]), jc, jnp.int32(t))
            jsteps_.append(lg)
    with torch.no_grad():
        enc = tencdec.encode(model, torch.from_numpy(frames), cfg)
        assert enc.dtype == torch.bfloat16
        got = tencdec.decode_train(model, torch.from_numpy(tokens), enc, cfg)
        cache = tencdec.init_encdec_cache(model, enc, cfg, 2, 4)
        assert cache["cross"][0]["k"].dtype == torch.bfloat16
        _close(got, want, 0.05)
        for t in range(2):
            lg, cache = tencdec.encdec_decode(model, torch.from_numpy(tokens[:, t:t + 1]),
                                              cache, t, cfg)
            _close(lg, jsteps_[t], 0.05)


# ---------------------------------------------------------------- serve ----
def _reference_audio_flow(prompt_len, gen, batch, temperature):
    """The lines of ``repro.launch.serve.main`` for the audio family, in
    their order (``main`` parses argv)."""
    cfg = jconfigs.get_smoke(ARCH).replace(dtype="float32")
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(0)
        params = jsteps.init_for(cfg)(key)
        cache_len = prompt_len + gen
        prompt = jax.random.randint(key, (batch, prompt_len), 0, cfg.vocab_size)
        frames = jax.random.normal(key, (batch, cfg.n_audio_frames, cfg.d_model))
        enc = jencdec.encode(params, frames, cfg)
        cache = jencdec.init_encdec_cache(params, enc, cfg, batch, cache_len)
        decode = jax.jit(lambda p, t, c, i: jencdec.encdec_decode(p, t, c, i, cfg))
        tok = jnp.zeros((batch, 1), jnp.int32)
        toks, last = [tok], []
        for i in range(gen):
            logits, cache = decode(params, tok, cache, jnp.int32(i))
            if temperature > 0:
                key, sk = jax.random.split(key)
                tok = jax.random.categorical(
                    sk, logits[:, -1] / temperature)[:, None].astype(jnp.int32)
            else:
                tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
            toks.append(tok)
            last.append(np.asarray(logits[:, -1]))
    out = np.concatenate([np.asarray(t) for t in toks], axis=1)
    return params, np.asarray(prompt), np.asarray(frames), out, last


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_generate_reproduces_the_reference_audio_flow(monkeypatch, temperature):
    """Equal prompt ids, frames (``normal`` from the prompt's own key) and
    sampled ids in fp32; every step's logits within 1e-5 of their
    scale; no prefill logits."""
    prompt_len, gen, batch = 8, 6, 3
    params, prompt, frames, want, last = _reference_audio_flow(prompt_len, gen,
                                                               batch, temperature)
    cfg = tconfigs.get_smoke(ARCH).replace(dtype="float32")
    model = tencdec.EncDec(cfg)
    model.load_state_dict(encdec_params_from_numpy(jax.device_get(params), cfg,
                                                   device="cpu"))
    seen = []
    encode = tencdec.encode
    monkeypatch.setattr(tencdec, "encode",
                        lambda m, f, c: seen.append(f.clone()) or encode(m, f, c))
    out = serve.generate(cfg, model, prompt_len=prompt_len, gen=gen, batch=batch,
                         temperature=temperature, seed=0, device="cpu")
    np.testing.assert_array_equal(out.prompt.numpy(), prompt)
    assert len(seen) == 1
    np.testing.assert_array_equal(seen[0].numpy(), frames)
    np.testing.assert_array_equal(out.ids.numpy(), want)
    assert out.first_logits is None and len(out.decode_logits) == gen
    for g, w in zip(out.decode_logits, last):
        _close(g, w)


# ---------------------------------------------------------------- steps ----
def test_step_builders_match_the_reference(pair):
    """The prefill step (encode, the decoder's last logits, a fresh cache:
    empty self caches, the cross K/V; ROADMAP C-25) and 2 serve steps from
    its cache, against the reference's builders."""
    jcfg, params, cfg, model = pair
    shape = tconfigs.ShapeConfig("tiny", 16, 2, "prefill")
    frames, tokens = _inputs(cfg, 2, 16, seed=6)
    with jax.threefry_partitionable(False):
        jlg, jcache = jsteps.build_prefill_step(jcfg, shape)(
            params, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)})
        jserve = jax.jit(jsteps.build_serve_step(jcfg))
        jout = []
        for t in range(2):
            lg, jcache = jserve(params, jcache, jnp.asarray(tokens[:, t:t + 1]),
                                jnp.int32(16 + t))
            jout.append(lg)
    with torch.no_grad():
        lg, cache = steps.build_prefill_step(cfg, shape)(
            model, {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(tokens)})
        assert all(int(c["slot_pos"].max()) == -1 for c in cache["self"])
        assert cache["self"][0]["k"].shape[1] == steps.cache_len_for(cfg, shape) == 16
        _close(lg, jlg)
        for t in range(2):
            out, cache = steps.build_serve_step(cfg)(
                model, cache, torch.from_numpy(tokens[:, t:t + 1]), 16 + t)
            _close(out, jout[t], msg=f"serve step {t}")
    for n in ("k", "v"):
        _close(np.stack([_np(c[n]) for c in cache["self"]]), jcache["self"][n])
        _close(np.stack([_np(c[n]) for c in cache["cross"]]), jcache["cross"][n])


def train_against_reference(pair, batches, loss_fn, to_numpy, lr=3e-4):
    """Steps of the reference's jitted train step and of the port's (AdamW
    at ``lr``, 2 microbatches, remat on) from the same weights, one a
    batch: every step's loss rtol 1e-5. The parameters after the first
    step within 1e-5 of each leaf's scale (p) but for the elements whose
    first update AdamW can move by more than that: the update g / (|g| +
    e), e = 1e-8, moves by e / (|g| + e)^2 times a gradient's error, and
    the gradients agree to 1e-5 of their leaf's scale (G;
    test_loss_gradients_match_the_reference), so these are the nonzero g
    with (|g| + e)^2 < lr e G / p (0.03-0.07% of the elements here; at
    most 0.5% allowed, test_torch_train's share); they stay within lr, the
    most one step moves them. Later steps' parameters are
    held through the losses only: an element first reached by a later
    step's gradient gets its first update from a gradient that already
    carries those perturbations (measured: 2.1e-5 of the embedding
    gradient's scale at the second step), which that update amplifies
    alike. Returns the two AdamW states."""
    jcfg, params, cfg, model = pair
    names = [k for k, _ in model.named_parameters()]
    jstep = jax.jit(jsteps.build_train_step(jcfg, lr=lr, microbatches=2))
    tstep = steps.build_train_step(cfg, lr=lr, microbatches=2)
    jopt, topt = j_adamw_init(params), adamw_init(dict(model.named_parameters()))
    jl, tl = [], []
    for i, b in enumerate(batches):
        if i == 0:
            loss, _ = loss_fn(model, b, cfg)
            first = _flat(to_numpy(dict(zip(names, torch.autograd.grad(
                loss, list(model.parameters())))), cfg))
        with jax.threefry_partitionable(False):
            params, jopt, loss = jstep(params, jopt, {k: jnp.asarray(t.numpy())
                                                      for k, t in b.items()})
        jl.append(float(loss))
        model, topt, loss = tstep(model, topt, b)
        tl.append(float(loss))
        if i > 0:
            continue
        got = _flat(to_numpy(dict(model.named_parameters()), cfg))
        want = _flat(jax.device_get(params))
        assert sorted(got) == sorted(want)
        n_sens = n_all = 0
        for k in want:
            g_scale = float(np.abs(first[k]).max())
            p_scale = float(np.abs(want[k]).max())
            sens = (first[k] != 0) & (
                (np.abs(first[k]) + 1e-8) ** 2 < lr * 1e-8 * g_scale / p_scale)
            n_sens += int(sens.sum())
            n_all += sens.size
            _close(got[k][~sens], want[k][~sens], msg=k)
            if sens.any():
                assert float(np.abs(got[k][sens] - want[k][sens]).max()) <= lr, k
        assert n_sens <= 5e-3 * n_all, (n_sens, n_all)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    return topt, jopt


def test_train_step_matches_the_reference():
    """Three steps on ``make_lm_batches``' audio batches
    (``train_against_reference``)."""
    pair = _pair(seed=2)
    cfg = pair[2]
    batches = list(train.make_lm_batches(cfg, 4, 24, 3, device="cpu"))
    topt, jopt = train_against_reference(pair, batches, tencdec.encdec_loss,
                                         encdec_params_to_numpy)
    assert int(adamw_state_to_numpy(topt, cfg)["step"]) == int(jopt["step"]) == 3


def port_shapes(params: dict, stacks: dict) -> dict:
    """The port's parameter shapes (name -> tensor, meta or not) as the
    JAX package's stacked tree's, without allocating: a per-layer leaf
    under its prefix's layer count."""
    out = {}
    for name, t in params.items():
        prefix = name.split(".", 1)[0]
        if prefix in stacks:
            _, _, rest = name.split(".", 2)
            out[f"{prefix}.{rest}"] = (stacks[prefix],) + tuple(t.shape)
        else:
            out[name] = tuple(t.shape)
    return out


def _shapes(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


def test_input_specs_params_and_opt_shapes_match_the_reference():
    """At whisper-tiny's full size, on the meta device: the parameters,
    the AdamW state, the train and prefill batches and the decode cache
    (self rings of 32,768 slots, cross K/V of 1,500 frames, per layer)
    against the reference's ``eval_shape``s."""
    jcfg, cfg = jconfigs.get_config(ARCH), tconfigs.get_config(ARCH)
    with jax.threefry_partitionable(False):
        jp = jsteps.params_shape(jcfg)
    p = steps.params_shape(cfg)
    assert all(t.device.type == "meta" for t in p.values())
    assert port_shapes(p, {"enc_layers": cfg.n_encoder_layers,
                           "dec_layers": cfg.n_layers}) == _shapes(jp)
    o = steps.opt_shape(p)
    assert set(o["m"]) == set(p) and all(t.device.type == "meta" for t in o["v"].values())
    for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
        want = jsteps.input_specs(ARCH, shape_name, jcfg)
        got = steps.input_specs(ARCH, shape_name, cfg)
        if shape_name != "decode_32k":
            assert {k: (tuple(t.shape), str(t.dtype)[6:]) for k, t in got.items()} == \
                {k: (tuple(s.shape), str(s.dtype)) for k, s in want.items()}
            continue
        assert got["token"].shape == want["token"].shape and got["pos"].shape == ()
        cache = got["cache"]
        for part in ("self", "cross"):
            assert len(cache[part]) == cfg.n_layers
            for n, s in want["cache"][part].items():
                assert all(c[n].device.type == "meta" for c in cache[part])
                assert (cfg.n_layers,) + tuple(cache[part][0][n].shape) == s.shape, (part, n)
                assert str(cache[part][0][n].dtype)[6:] == str(s.dtype), (part, n)


# ------------------------------------------------- converters and CLIs ----
def test_converters_and_adamw_state_both_ways(pair):
    jcfg, params, cfg, model = pair
    tree = jax.device_get(params)
    conv = encdec_params_from_numpy(tree, cfg, device="cpu")
    assert sorted(conv) == sorted(n for n, _ in model.named_parameters())
    back = _flat(model_params_to_numpy(conv, cfg))
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    with pytest.raises(ValueError, match="enc_layers"):
        encdec_params_from_numpy(tree, cfg.replace(n_encoder_layers=3), device="cpu")
    with pytest.raises(ValueError, match="dec_layers"):
        encdec_params_from_numpy(tree, cfg.replace(n_layers=3), device="cpu")
    st = adamw_init(dict(model.named_parameters()))
    for t in st["m"].values():
        t.normal_(generator=torch.Generator().manual_seed(0))
    st["step"] += 3
    jst = adamw_state_to_numpy(st, cfg)
    assert _shapes(jst["v"]) == _shapes(tree)
    again = adamw_state_from_numpy(jst, cfg, device="cpu")
    for mom in ("m", "v"):
        assert all(torch.equal(again[mom][k], st[mom][k]) for k in st[mom])
    assert int(again["step"]) == 3


def test_lm_batches_match_the_reference():
    """Audio batches: the token stream's ids and the frames drawn from
    ``default_rng(seed + step)``, equal to the reference's, from a resumed
    step too."""
    cfg = tconfigs.get_smoke(ARCH)
    got = list(train.make_lm_batches(cfg, 2, 16, 2, seed=3, start_step=1, device="cpu"))
    want = list(jtrain.make_lm_batches(jconfigs.get_smoke(ARCH), 2, 16, 2, seed=3,
                                       start_step=1))
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["frames", "tokens"]
        for k in g:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


def test_family_checks_admit_the_audio_family():
    cfg = tconfigs.get_smoke(ARCH)
    ttfm.check_family(cfg)
    assert isinstance(steps.init_for(cfg)(torch.Generator().manual_seed(0)),
                      tencdec.EncDec)
    with pytest.raises(ValueError, match="encoder-decoder"):
        ttfm.LM(cfg)
    with pytest.raises(ValueError, match="not audio"):
        tencdec.EncDec(tconfigs.get_smoke("tinyllama-1.1b"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jconfigs.get_smoke(ARCH))


def test_train_and_serve_clis_run_on_the_cpu(capsys):
    losses = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--steps", "6", "--batch", "2", "--seq", "32"])
    assert len(losses) == 6 and np.isfinite(losses).all() and losses[-1] < losses[0]
    serve.main(["--arch", ARCH, "--smoke", "--prompt-len", "8", "--gen", "3",
                "--batch", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert any(ln.startswith(f"{ARCH}: prefill 8 tok in ") for ln in lines)
