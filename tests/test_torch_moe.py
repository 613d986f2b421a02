"""The port's MoE family (qwen2-moe, mixtral) against the JAX package.

``_dispatch_tensors`` on the same router probabilities (ties included)
gives the same dispatch and combine tensors, so the same masks and slots,
bit for bit; ``moe_forward``'s output and aux loss agree within 1e-5 in
fp32 with tokens dropped at capacity; the whole smoke models' forward,
prefill, decode steps and caches agree at ``test_torch_lm``'s ATOL (2e-4)
in fp32 and 0.05 in bf16; ``lm_loss`` (xent and aux) within 1e-5; and
``generate()`` reproduces the reference serve flow. Weights come from the
JAX package's init through ``repro_torch.convert``; every JAX call runs
under ``jax.threefry_partitionable(False)``. The JAX reference runs of a
model are shared through module-scoped fixtures.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.launch import serve, steps
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from test_torch_lm import (ATOL, _models, _np, _reference_serve_flow,
                           _stack_cache, _tokens)

ARCHS = ("qwen2-moe-a2.7b", "mixtral-8x22b")
# prompt, decode steps and ring size: mixtral's prompt outruns its 64-token
# smoke window, and its ring of 64 slots is the window (steps.cache_len_for)
RUN = {"qwen2-moe-a2.7b": (16, 4, 20), "mixtral-8x22b": (96, 4, 64)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one intra-op thread: the suite runs several
    workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- dispatch ----
def _probs_with_ties(seed, G, g, E) -> np.ndarray:
    """Softmax rows, some with a tied maximum (first index must win) and
    some with every expert tied."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((G, g, E)).astype(np.float32)
    logits[0, ::3, E // 2] = logits[0, ::3, 1] = logits[0, ::3].max(-1) + 1.0
    logits[-1, 1::4] = 0.0
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("G,g,E,k,capacity", [
    (3, 16, 4, 2, 5),          # drops: 32 picks over 4 experts of 5 slots
    (2, 32, 60, 4, 2),         # qwen2-moe's experts
    (4, 1, 8, 2, 1),           # a decode step: g = 1, capacity 1
    (2, 24, 8, 2, 48),         # no drops
])
def test_dispatch_tensors_equal_bit_for_bit(G, g, E, k, capacity):
    probs = _probs_with_ties(G * g + E, G, g, E)
    jd, jc = jmoe._dispatch_tensors(jnp.asarray(probs), k, capacity)
    td, tc = tmoe._dispatch_tensors(torch.from_numpy(probs), k, capacity)
    assert td.dtype == tc.dtype == torch.float32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    if g == 1:                                  # a decode step drops nothing
        assert td.numpy().sum() == G * g * k


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_and_dispatch_match_the_reference(arch):
    """Groups of 16 of 48 tokens, capacity int(1.25 k 16 / E): tokens are
    dropped. The router's probabilities agree to fp32 rounding; on the JAX
    package's probabilities the masks are equal bit for bit."""
    jcfg, params, cfg, model = _models(arch, moe_group=16)
    jp = jax.tree_util.tree_map(lambda t: t[0], params["layers"]["moe"])
    x = (np.random.default_rng(3).standard_normal((2, 48, cfg.d_model)) * 0.5
         ).astype(np.float32)
    want, jaux = jmoe.moe_forward(jp, jnp.asarray(x), jcfg)
    moe = model.layers[0].moe
    with torch.no_grad():
        got, aux = tmoe.moe_forward(moe, torch.from_numpy(x), cfg)
        probs = tmoe.router_probs(moe, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-5, rtol=0)

    jprobs = jax.nn.softmax(jnp.asarray(x) @ jp["router"]["w"], axis=-1)
    np.testing.assert_allclose(_np(probs), _np(jprobs), atol=1e-6, rtol=0)
    E, k = cfg.n_experts, cfg.n_experts_per_tok
    cap = max(1, int(cfg.capacity_factor * k * 16 / E))
    grouped = np.array(jprobs).reshape(6, 16, E)
    jd, jc = jmoe._dispatch_tensors(jnp.asarray(grouped), k, cap)
    td, tc = tmoe._dispatch_tensors(torch.from_numpy(grouped), k, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert td.numpy().sum() < 2 * 48 * k        # some token was dropped


# ---------------------------------------------------------------- model ----
# bf16: the two frameworks' bf16 hidden states differ by a few bf16 ulps (a
# few 0.1%), which moves the fp32 router probabilities by up to ~1% of
# their size; a token whose k-th and (k+1)-th probabilities lie closer than
# ROUTING_TIE in some layer may be routed to another expert (an fp tie).
# So bf16 runs at capacity 8 (no token dropped, so a flip cannot move
# another token's slot) and compares the positions that are no tie in any
# layer; fp32 compares every position at the default capacity, drops
# included.
ROUTING_TIE = 0.01


@pytest.fixture(scope="module", params=[(a, dt) for a in ARCHS
                                        for dt in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def reference_run(request):
    """One JAX run a (arch, dtype): forward over prompt + steps, prefill,
    the decode steps and the final caches; and the port's model."""
    arch, dtype = request.param
    S, T, cache_len = RUN[arch]
    replace = {"capacity_factor": 8.0} if dtype == "bfloat16" else {}
    jcfg, params, cfg, model = _models(arch, dtype=dtype, **replace)
    toks = _tokens((2, S + T), cfg.vocab_size, seed=21)
    with jax.threefry_partitionable(False):
        full, jaux = jtfm.lm_forward(params, jnp.asarray(toks), jcfg)
        lg, cache = jtfm.lm_prefill(params, jnp.asarray(toks[:, :S]), jcfg,
                                    cache_len=cache_len)
        steps_lg = [lg]
        for t in range(S, S + T):
            lg, cache = jtfm.lm_decode(params, jnp.asarray(toks[:, t:t + 1]), cache,
                                       jnp.int32(t), jcfg)
            steps_lg.append(lg)
    return dict(arch=arch, dtype=dtype, cfg=cfg, model=model, toks=toks,
                full=_np(full), aux=float(jaux), steps=[_np(x) for x in steps_lg],
                cache=jax.device_get(cache))


def _routing_ties(model, toks, cfg) -> np.ndarray:
    """[B, S] bool: the positions whose top-k router margin is under
    ROUTING_TIE in some layer of the port's forward."""
    probs = []
    real = tmoe.router_probs
    tmoe.router_probs = lambda p, x: probs.append(real(p, x)) or probs[-1]
    try:
        with torch.no_grad():
            ttfm.lm_forward(model, toks, cfg)
    finally:
        tmoe.router_probs = real
    k = cfg.n_experts_per_tok
    ties = np.zeros(tuple(toks.shape), bool)
    for p in probs:
        top = torch.topk(p, k + 1, dim=-1).values
        ties |= (top[..., k - 1] - top[..., k]).numpy() < ROUTING_TIE
    return ties


def test_forward_prefill_decode_and_caches_match_the_reference(reference_run):
    """fp32 at ATOL, every position; bf16 at 0.05 (``test_torch_lm``'s bf16
    bound: the frameworks round bf16 matmuls and silu differently) on the
    positions that are no routing tie, at least 80% of them (92.5% of
    qwen2-moe's and 85% of mixtral's are kept)."""
    r = reference_run
    cfg, model, toks = r["cfg"], r["model"], torch.from_numpy(r["toks"])
    S, T, cache_len = RUN[r["arch"]]
    f32 = r["dtype"] == "float32"
    atol = ATOL if f32 else 0.05
    keep = (np.ones(toks.shape, bool) if f32
            else ~_routing_ties(model, toks, cfg))
    assert keep.mean() >= 0.8, f"{keep.mean():.1%} of the positions kept"
    with torch.no_grad():
        full, aux = ttfm.lm_forward(model, toks, cfg)
        lg, cache = ttfm.lm_prefill(model, toks[:, :S], cfg, cache_len=cache_len)
        got = [lg]
        for t in range(S, S + T):
            lg, cache = ttfm.lm_decode(model, toks[:, t:t + 1], cache, t, cfg)
            got.append(lg)
    np.testing.assert_allclose(_np(full)[keep], r["full"][keep], atol=atol, rtol=0)
    np.testing.assert_allclose(float(aux), r["aux"], atol=1e-5 if f32 else 1e-3,
                               rtol=0)
    for t, (g, w) in enumerate(zip(got, r["steps"]), start=S - 1):
        rows = keep[:, t]
        np.testing.assert_allclose(_np(g)[rows], w[rows], atol=atol, rtol=0)
    got_c = _stack_cache(cache)
    want_slot = np.asarray(r["cache"]["layers"]["slot_pos"])
    np.testing.assert_array_equal(got_c["slot_pos"], want_slot)
    # a slot holds position slot_pos: compare the slots of kept positions
    pos = want_slot[0]
    slot_keep = keep[:, np.clip(pos, 0, None)] & (pos >= 0)           # [B, W]
    for n in ("k", "v"):
        want = _np(r["cache"]["layers"][n])
        np.testing.assert_allclose(got_c[n][:, slot_keep], want[:, slot_keep],
                                   atol=atol, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_xent_and_aux_match_the_reference(arch):
    jcfg, params, cfg, model = _models(arch)
    toks = _tokens((2, 24), cfg.vocab_size, seed=22)
    labels = toks.copy()
    labels[:, :3] = -1                              # masked positions
    for batch in ({"tokens": toks}, {"tokens": toks, "labels": labels}):
        want, jm = jtfm.lm_loss(params, {k: jnp.asarray(v) for k, v in batch.items()},
                                jcfg)
        with torch.no_grad():
            got, m = ttfm.lm_loss(model, {k: torch.from_numpy(v)
                                          for k, v in batch.items()}, cfg)
        assert float(m["aux"]) > 0
        for a, b in ((got, want), (m["xent"], jm["xent"]), (m["aux"], jm["aux"])):
            np.testing.assert_allclose(float(a), float(b), atol=1e-5, rtol=0)


def test_prefill_then_decode_continues_the_ports_own_forward():
    """The JAX package's recipe (``tests/test_decode.py``): with capacity 8
    (no token dropped) prefill and decode equal the full forward."""
    _, _, cfg, model = _models("qwen2-moe-a2.7b", capacity_factor=8.0)
    S, T = 16, 3
    toks = torch.from_numpy(_tokens((2, S + T), cfg.vocab_size, seed=23))
    with torch.no_grad():
        full, _ = ttfm.lm_forward(model, toks, cfg)
        lg, cache = ttfm.lm_prefill(model, toks[:, :S], cfg, cache_len=S + T)
        np.testing.assert_allclose(_np(lg[:, 0]), _np(full[:, S - 1]), atol=ATOL, rtol=0)
        for t in range(S, S + T):
            lg, cache = ttfm.lm_decode(model, toks[:, t:t + 1], cache, t, cfg)
            np.testing.assert_allclose(_np(lg[:, 0]), _np(full[:, t]), atol=ATOL, rtol=0)


# ------------------------------------------------------ serving copy, I/O ----
@pytest.mark.parametrize("inplace", [False, True])
def test_serving_copy_keeps_the_router_fp32(inplace):
    cfg = tconfigs.get_smoke("qwen2-moe-a2.7b")                 # bf16
    model = ttfm.LM(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens((1, 12), cfg.vocab_size, seed=24))
    with torch.no_grad():
        want = ttfm.lm_forward(model, toks, cfg)
    fast = ttfm.for_compute(model, cfg, inplace=inplace)
    assert (fast is model) == inplace
    moe = fast.layers[0].moe
    assert moe.router.w.dtype == torch.float32
    assert {moe.w_gate.dtype, moe.w_up.dtype, moe.w_down.dtype} == {torch.bfloat16}
    assert moe.shared.gate.w.dtype == torch.bfloat16
    assert fast.layers[0].attn.wq.b.dtype == torch.bfloat16
    assert fast.lm_head.table.dtype == fast.layers[0].ln1.scale.dtype == torch.float32
    if not inplace:
        assert model.layers[0].moe.w_gate.dtype == torch.float32  # master untouched
    with torch.no_grad():
        got = ttfm.lm_forward(fast, toks, cfg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ttfm.for_compute(fast, cfg) is fast


@pytest.mark.parametrize("arch", ARCHS)
def test_converted_names_are_the_modules_parameters_both_ways(arch):
    jcfg, params, cfg, model = _models(arch)
    tree = jax.device_get(params)
    conv = lm_params_from_numpy(tree, cfg, device="cpu")
    assert sorted(conv) == sorted(n for n, _ in model.named_parameters())
    back = lm_params_to_numpy(dict(model.named_parameters()), cfg)
    flat = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


def test_decode_input_specs_and_step_builders():
    cfg = tconfigs.get_config("qwen2-moe-a2.7b")
    spec = steps.input_specs("qwen2-moe-a2.7b", "decode_32k")
    assert len(spec["cache"]["layers"]) == cfg.n_layers
    assert spec["cache"]["layers"][0]["k"].shape == (128, 32768, 16, 128)
    assert spec["cache"]["layers"][0]["k"].device.type == "meta"
    p = steps.params_shape(cfg)
    assert p["layers.0.moe.w_gate"].shape == (60, 2048, 1408)
    assert p["layers.0.moe.shared.gate.w"].shape == (2048, 4 * 1408)
    assert 14.2e9 < sum(t.numel() for t in p.values()) < 14.4e9
    _, _, scfg, model = _models("mixtral-8x22b")
    shape = tconfigs.ShapeConfig("tiny", 12, 2, "prefill")
    toks = torch.from_numpy(_tokens((2, 12), scfg.vocab_size, seed=25))
    with torch.no_grad():
        lg, cache = steps.build_prefill_step(scfg, shape)(model, {"tokens": toks})
        lg2, _ = steps.build_serve_step(scfg)(model, cache, toks[:, -1:], 12)
        loss, m = steps.loss_for(scfg)(model, {"tokens": toks})
    assert lg2.shape == (2, 1, scfg.vocab_size) and float(m["aux"]) > 0


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_generate_reproduces_the_reference_serve_flow(temperature):
    arch, prompt_len, gen, batch = "qwen2-moe-a2.7b", 16, 5, 2
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
    serve.main(["--arch", "qwen2-moe-a2.7b", "--smoke", "--prompt-len", "8",
                "--gen", "3", "--batch", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("qwen2-moe-a2.7b: prefill 8 tok in ")
    assert "decoded 3 tok" in lines[0]
