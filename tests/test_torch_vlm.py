"""The port's VLM family (phi-3-vision: the dense stack and
``vision_proj``) against the JAX package.

``lm_forward``, ``lm_loss`` (the text region) and its gradients,
``lm_prefill`` and 4 decode steps with their caches, all with
``extra_embeds`` prepended; a prefill of 16 vision and 2,032 text
positions, which takes the flash branch (the kernel's plain version
here); the serving copy; the serve flow (the dense one, as the
reference's); the step builders, meta-device specs, converters, batches
and CLIs. Weights come from the JAX package's init through
``repro_torch.convert``; every JAX call runs under
``jax.threefry_partitionable(False)``.

Tolerances (``test_torch_lm``'s): fp32 within 1e-5 of each result's
scale, gradients within 1e-5 of each leaf's scale; bf16 within 5% of the
logits' scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import transformer as jtfm
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve, steps, train
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm
from test_torch_encdec import (_close, _flat, _np, _shapes, port_shapes,
                               train_against_reference)
from test_torch_lm import _reference_serve_flow

ARCH = "phi-3-vision-4.2b"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one intra-op thread: the suite runs several
    workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(dtype="float32", seed=0):
    jcfg = jconfigs.get_smoke(ARCH).replace(dtype=dtype)
    cfg = tconfigs.get_smoke(ARCH).replace(dtype=dtype)
    with jax.threefry_partitionable(False):
        params = jtfm.init_lm(jax.random.PRNGKey(seed), jcfg)
    model = ttfm.LM(cfg)
    model.load_state_dict(lm_params_from_numpy(jax.device_get(params), cfg,
                                               device="cpu"))
    return jcfg, params, cfg, model


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _inputs(cfg, B, S_text, seed=1):
    rng = np.random.default_rng(seed)
    extra = rng.standard_normal((B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, S_text)).astype(np.int32)
    return extra, tokens


@pytest.fixture(scope="module")
def reference_run(pair):
    """The reference's forward, loss (and with masked labels), prefill and
    4 decode steps with ``extra_embeds``: 2 requests, 16 vision positions
    and 12 + 4 text ids."""
    jcfg, params, cfg, model = pair
    extra, tokens = _inputs(cfg, 2, 16)
    labels = tokens.copy()
    labels[:, ::3] = -1
    je, jt = jnp.asarray(extra), jnp.asarray(tokens)
    with jax.threefry_partitionable(False):
        full, aux = jtfm.lm_forward(params, jt, jcfg, extra_embeds=je)
        loss, _ = jtfm.lm_loss(params, {"tokens": jt, "extra_embeds": je}, jcfg)
        masked, _ = jtfm.lm_loss(params, {"tokens": jt, "extra_embeds": je,
                                          "labels": jnp.asarray(labels)}, jcfg)
        lg, cache = jtfm.lm_prefill(params, jt[:, :12], jcfg, cache_len=40,
                                    extra_embeds=je)
        decode = jax.jit(lambda p, t, c, i: jtfm.lm_decode(p, t, c, i, jcfg))
        steps_lg = [np.asarray(lg)]
        for t in range(12, 16):
            lg, cache = decode(params, jt[:, t:t + 1], cache,
                               jnp.int32(cfg.n_vision_tokens + t))
            steps_lg.append(np.asarray(lg))
    return dict(extra=extra, tokens=tokens, labels=labels, full=np.asarray(full),
                aux=float(aux), loss=float(loss), masked=float(masked),
                steps=steps_lg, cache=jax.device_get(cache))


def test_forward_and_loss_with_extra_embeds_match_the_reference(pair, reference_run):
    """The logits of all 32 positions (the projected vision embeddings
    first), and the loss over the text region only, with and without
    masked labels."""
    jcfg, params, cfg, model = pair
    r = reference_run
    extra, tokens = torch.from_numpy(r["extra"]), torch.from_numpy(r["tokens"])
    with torch.no_grad():
        full, aux = ttfm.lm_forward(model, tokens, cfg, extra_embeds=extra)
        loss, m = ttfm.lm_loss(model, {"tokens": tokens, "extra_embeds": extra}, cfg)
        masked, _ = ttfm.lm_loss(model, {"tokens": tokens, "extra_embeds": extra,
                                         "labels": torch.from_numpy(r["labels"])}, cfg)
    assert full.shape == (2, cfg.n_vision_tokens + 16, cfg.vocab_size)
    _close(full, r["full"])
    assert float(aux) == r["aux"] == 0.0
    np.testing.assert_allclose(float(loss), r["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(masked), r["masked"], rtol=1e-5)
    assert float(m["xent"]) == float(loss)


def test_prefill_and_decode_with_extra_embeds_match_the_reference(pair, reference_run):
    """Prefill over 16 vision and 12 text positions, then 4 decode steps at
    positions 28-31: logits and the ring caches (K/V, slot positions)."""
    jcfg, params, cfg, model = pair
    r = reference_run
    extra, tokens = torch.from_numpy(r["extra"]), torch.from_numpy(r["tokens"])
    with torch.no_grad():
        lg, cache = ttfm.lm_prefill(model, tokens[:, :12], cfg, cache_len=40,
                                    extra_embeds=extra)
        got = [lg]
        for t in range(12, 16):
            lg, cache = ttfm.lm_decode(model, tokens[:, t:t + 1], cache,
                                       cfg.n_vision_tokens + t, cfg)
            got.append(lg)
        full, _ = ttfm.lm_forward(model, tokens, cfg, extra_embeds=extra)
    for i, (g, w) in enumerate(zip(got, r["steps"])):
        _close(g, w, msg=f"step {i}")
        _close(g[:, 0], full[:, cfg.n_vision_tokens + 11 + i], msg=f"step {i} vs forward")
    for n in ("k", "v"):
        _close(np.stack([_np(c[n]) for c in cache["layers"]]), r["cache"]["layers"][n])
    np.testing.assert_array_equal(np.stack([c["slot_pos"].numpy() for c in cache["layers"]]),
                                  np.asarray(r["cache"]["layers"]["slot_pos"]))


def test_loss_gradients_match_the_reference(pair, reference_run):
    """``jax.grad`` of the reference's loss with ``extra_embeds`` against
    the port's backward, ``vision_proj`` included (remat on)."""
    jcfg, params, cfg, model = pair
    r = reference_run
    batch = {"tokens": torch.from_numpy(r["tokens"]),
             "extra_embeds": torch.from_numpy(r["extra"])}
    loss, _ = ttfm.lm_loss(model, batch, cfg)
    names = [n for n, _ in model.named_parameters()]
    got = _flat(lm_params_to_numpy(dict(zip(names, torch.autograd.grad(
        loss, list(model.parameters())))), cfg))
    with jax.threefry_partitionable(False):
        jg = jax.jit(jax.grad(lambda p, b: jtfm.lm_loss(p, b, jcfg)[0]))(
            params, {k: jnp.asarray(t.numpy()) for k, t in batch.items()})
    want = _flat(jax.device_get(jg))
    assert sorted(got) == sorted(want) and "vision_proj.w" in want
    for k in want:
        _close(got[k], want[k], msg=k)


def test_prefill_at_the_flash_threshold_matches_the_reference(pair, monkeypatch):
    """16 vision and 2,032 text positions: 2,048, so every layer's
    attention takes the flash branch in both packages (the port's wrapper,
    its plain version here); last logits and caches, then one decode
    step. The rotated keys within test_torch_lm's ATOL (2e-4): inside its
    scanned prefill the reference folds the RoPE frequencies in float64
    (ROADMAP C-21), which moves keys at 2,047 positions by ~1e-4."""
    jcfg, params, cfg, model = pair
    extra, tokens = _inputs(cfg, 1, 2033, seed=2)
    je, jt = jnp.asarray(extra), jnp.asarray(tokens)
    with jax.threefry_partitionable(False):
        jlg, jcache = jtfm.lm_prefill(params, jt[:, :2032], jcfg, cache_len=2049,
                                      extra_embeds=je)
        jstep, jcache = jtfm.lm_decode(params, jt[:, 2032:], jcache, jnp.int32(2048), jcfg)
    calls = []
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **kw: calls.append(a[0].shape) or
                        flash_ops.flash_attention(*a, **kw))
    with torch.no_grad():
        lg, cache = ttfm.lm_prefill(model, torch.from_numpy(tokens[:, :2032]), cfg,
                                    cache_len=2049, extra_embeds=torch.from_numpy(extra))
        step, cache = ttfm.lm_decode(model, torch.from_numpy(tokens[:, 2032:]), cache,
                                     2048, cfg)
    assert [c[1] for c in calls] == [2048] * cfg.n_layers
    _close(lg, jlg)
    _close(step, jstep)
    np.testing.assert_allclose(np.stack([_np(c["k"]) for c in cache["layers"]]),
                               np.asarray(jcache["layers"]["k"]), atol=2e-4, rtol=0)
    _close(np.stack([_np(c["v"]) for c in cache["layers"]]), jcache["layers"]["v"])


def test_zero_vision_embeddings_overflow_the_gradient_at_depth_c26():
    """ROADMAP C-26, on the reference's side: its VLM train batches hold
    zero ``extra_embeds``; those positions' hidden states stay exactly zero
    through every layer, where RMSNorm's derivative is 1/sqrt(eps) ~ 316,
    so their gradient grows about that much a layer. At the smoke width
    and 24 layers (the depth phase 13 (e) trains) the gradient is NaN in
    both packages alike, and finite in the port with normal embeddings."""
    jcfg = jconfigs.get_smoke(ARCH).replace(dtype="float32", n_layers=24)
    cfg = tconfigs.get_smoke(ARCH).replace(dtype="float32", n_layers=24)
    with jax.threefry_partitionable(False):
        params = jtfm.init_lm(jax.random.PRNGKey(0), jcfg)
    model = ttfm.LM(cfg)
    model.load_state_dict(lm_params_from_numpy(jax.device_get(params), cfg,
                                               device="cpu"))
    batch = next(train.make_lm_batches(cfg, 2, 64, 1, device="cpu"))
    assert not batch["extra_embeds"].any()
    with jax.threefry_partitionable(False):
        jg = jax.jit(jax.grad(lambda p, b: jtfm.lm_loss(p, b, jcfg)[0]))(
            params, {k: jnp.asarray(t.numpy()) for k, t in batch.items()})
    assert not np.isfinite(np.asarray(jg["vision_proj"]["w"])).all()

    def port_grads(b):
        loss, _ = ttfm.lm_loss(model, b, cfg)
        return torch.autograd.grad(loss, list(model.parameters()))
    assert not all(bool(torch.isfinite(g).all()) for g in port_grads(batch))
    normal = dict(batch, extra_embeds=torch.from_numpy(np.random.default_rng(5).standard_normal(
        tuple(batch["extra_embeds"].shape)).astype(np.float32)))
    assert all(bool(torch.isfinite(g).all()) for g in port_grads(normal))


def test_bf16_forward_and_decode_within_five_percent(reference_run):
    jcfg, params, cfg, model = _pair(dtype="bfloat16")
    r = reference_run
    je, jt = jnp.asarray(r["extra"]), jnp.asarray(r["tokens"])
    with jax.threefry_partitionable(False):
        want, _ = jtfm.lm_forward(params, jt, jcfg, extra_embeds=je)
        jlg, jcache = jtfm.lm_prefill(params, jt[:, :12], jcfg, cache_len=20,
                                      extra_embeds=je)
        jlg, _ = jtfm.lm_decode(params, jt[:, 12:13], jcache, jnp.int32(28), jcfg)
    extra, tokens = torch.from_numpy(r["extra"]), torch.from_numpy(r["tokens"])
    with torch.no_grad():
        got, _ = ttfm.lm_forward(model, tokens, cfg, extra_embeds=extra)
        _close(got, want, 0.05)
        _, cache = ttfm.lm_prefill(model, tokens[:, :12], cfg, cache_len=20,
                                   extra_embeds=extra)
        lg, _ = ttfm.lm_decode(model, tokens[:, 12:13], cache, 28, cfg)
    _close(lg, jlg, 0.05)


def test_serving_copy_casts_vision_proj(pair):
    jcfg, params, cfg, model = pair
    bcfg = cfg.replace(dtype="bfloat16")
    fast = ttfm.for_compute(model, bcfg)
    assert fast.vision_proj.w.dtype == torch.bfloat16
    assert fast.layers[0].ln1.scale.dtype == torch.float32
    assert model.vision_proj.w.dtype == torch.float32
    extra, tokens = _inputs(cfg, 1, 8, seed=3)
    with torch.no_grad():
        a = ttfm.lm_forward(fast, torch.from_numpy(tokens), bcfg,
                            extra_embeds=torch.from_numpy(extra))[0]
        b = ttfm.lm_forward(model, torch.from_numpy(tokens), bcfg,
                            extra_embeds=torch.from_numpy(extra))[0]
    assert torch.equal(a, b)


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_generate_reproduces_the_reference_serve_flow(temperature):
    """The reference's ``serve.py`` serves the VLM through the dense flow,
    without vision embeddings; so does the port: equal prompt and sampled
    ids, the last step's logits within 1e-5 of their scale."""
    prompt_len, gen, batch = 16, 4, 2
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
    _close(out.decode_logits[-1], last)


# ---------------------------------------------------------------- steps ----
def test_step_builders_match_the_reference(pair):
    """The prefill step with ``extra_embeds`` (the vision path) and 2 serve
    steps after it, against the reference's builders."""
    jcfg, params, cfg, model = pair
    shape = tconfigs.ShapeConfig("tiny", 32, 2, "prefill")
    extra, tokens = _inputs(cfg, 2, 18, seed=4)
    jb = {"tokens": jnp.asarray(tokens[:, :16]), "extra_embeds": jnp.asarray(extra)}
    with jax.threefry_partitionable(False):
        jlg, jcache = jsteps.build_prefill_step(jcfg, shape)(params, jb)
        jout = []
        jserve = jax.jit(jsteps.build_serve_step(jcfg))
        for t in range(2):
            lg, jcache = jserve(params, jcache, jnp.asarray(tokens[:, 16 + t:17 + t]),
                                jnp.int32(32 + t))
            jout.append(lg)
    with torch.no_grad():
        lg, cache = steps.build_prefill_step(cfg, shape)(
            model, {"tokens": torch.from_numpy(tokens[:, :16]),
                    "extra_embeds": torch.from_numpy(extra)})
        _close(lg, jlg)
        for t in range(2):
            out, cache = steps.build_serve_step(cfg)(
                model, cache, torch.from_numpy(tokens[:, 16 + t:17 + t]), 32 + t)
            _close(out, jout[t], msg=f"serve step {t}")


def test_train_step_matches_the_reference():
    """Three steps on ``make_lm_batches``' VLM batches (zero
    ``extra_embeds``; ``test_torch_encdec.train_against_reference``)."""
    pair = _pair(seed=2)
    cfg = pair[2]
    batches = list(train.make_lm_batches(cfg, 4, 24, 3, device="cpu"))
    assert batches[0]["extra_embeds"].shape == (4, cfg.n_vision_tokens, cfg.d_model)
    train_against_reference(pair, batches, lambda m, b, c: ttfm.lm_loss(m, b, c),
                            lm_params_to_numpy)


def test_input_specs_and_params_shape_match_the_reference():
    """At phi-3-vision-4.2b's full size on the meta device: the parameters
    (``vision_proj`` among them), the train and prefill batches (text ids
    after the 576 vision positions) and the decode cache."""
    jcfg, cfg = jconfigs.get_config(ARCH), tconfigs.get_config(ARCH)
    with jax.threefry_partitionable(False):
        jp = jsteps.params_shape(jcfg)
    p = steps.params_shape(cfg)
    assert all(t.device.type == "meta" for t in p.values())
    assert port_shapes(p, {"layers": cfg.n_layers}) == _shapes(jp)
    for shape_name in ("train_4k", "prefill_32k"):
        want = jsteps.input_specs(ARCH, shape_name, jcfg)
        got = steps.input_specs(ARCH, shape_name, cfg)
        assert {k: (tuple(t.shape), str(t.dtype)[6:]) for k, t in got.items()} == \
            {k: (tuple(s.shape), str(s.dtype)) for k, s in want.items()}
        assert all(t.device.type == "meta" for t in got.values())
    dec = steps.input_specs(ARCH, "decode_32k", cfg)
    want = jsteps.input_specs(ARCH, "decode_32k", jcfg)["cache"]["layers"]
    assert len(dec["cache"]["layers"]) == cfg.n_layers
    assert (cfg.n_layers,) + tuple(dec["cache"]["layers"][0]["k"].shape) == want["k"].shape


# ------------------------------------------------- converters and CLIs ----
def test_converters_carry_vision_proj(pair):
    jcfg, params, cfg, model = pair
    tree = jax.device_get(params)
    conv = lm_params_from_numpy(tree, cfg, device="cpu")
    assert "vision_proj.w" in conv and "vision_proj.b" not in conv
    assert sorted(conv) == sorted(n for n, _ in model.named_parameters())
    back = _flat(lm_params_to_numpy(conv, cfg))
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_lm_batches_match_the_reference():
    cfg = tconfigs.get_smoke(ARCH)
    got = list(train.make_lm_batches(cfg, 2, 40, 2, seed=1, device="cpu"))
    want = list(jtrain.make_lm_batches(jconfigs.get_smoke(ARCH), 2, 40, 2, seed=1))
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["extra_embeds", "tokens"]
        for k in g:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


def test_train_and_serve_clis_run_on_the_cpu(capsys):
    """The train CLI raises --seq to n_vision_tokens + 32, as the
    reference's does."""
    losses = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--steps", "6", "--batch", "2", "--seq", "8"])
    assert len(losses) == 6 and np.isfinite(losses).all() and losses[-1] < losses[0]
    serve.main(["--arch", ARCH, "--smoke", "--prompt-len", "8", "--gen", "3",
                "--batch", "2", "--device", "cpu"])
    assert f"{ARCH}: prefill 8 tok in " in capsys.readouterr().out
