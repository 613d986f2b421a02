"""Dense LM training against the JAX package.

The Markov token stream (ids equal), AdamW (``optim.adamw``) against the
reference's on random trees, ``lm_loss`` and ``build_train_step`` on the
smoke TinyLlama at S = 2048 in fp32 (the flash branch: ``flash_fwd_ref``
forward, ``flash_bwd_ref`` backward, remat on) against the reference's
jitted step from the same weights (carried by ``convert``), the train CLI
end to end, and its checkpoints crossing between the packages both ways.
Every reference call runs under ``jax.threefry_partitionable(False)``.

Tolerances: AdamW bit for bit (the reference's ops run eagerly, one
rounding each; the bias corrections use XLA's ``powf``); the first step's
gradients within 1e-5 of each leaf's scale and losses rtol 1e-5 (the
forward's and backward's sums add in other orders; the jitted reference
may contract multiply-adds). Parameters after 3 steps at the reference's
default lr 3e-4: within 1e-5 of each leaf's scale on every element whose
first gradient is 0 (an unused embedding row) or at least 1e-7 in
magnitude. On the others (at most 0.5% of a leaf; measured 0.12% at most)
AdamW's first update ``g / (|g| + 1e-8)`` turns a gradient difference of
~1e-9 into an update difference of up to ~0.1, so they are held to the
most 3 steps can move an element, 3 lr. (At lr 1e-3 the parameters those
elements perturb shift the later gradients enough that other elements
reach 4.7e-5 of their scale: the error grows as lr squared.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.data import make_token_stream as j_token_stream
from repro.launch import steps as jsteps
from repro.models import transformer as jtfm
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro_torch.configs import get_smoke
from repro_torch.convert import (adamw_state_from_numpy, adamw_state_to_numpy,
                                 lm_params_from_numpy, lm_params_to_numpy)
from repro_torch.data import make_token_stream
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import steps, train
from repro_torch.models import transformer as ttfm
from repro_torch.optim import adamw_init, adamw_update

ARCH = "tinyllama-1.1b"
SEQ, BATCH, STEPS, LR = 2048, 2, 3, 3e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one intra-op thread: the suite runs several
    workers on the machine's cores, and a process with a thread a core
    each slows all of them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scale_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_token_stream_ids_equal_the_reference():
    for n, vocab, seed in ((5000, 512, 0), (3001, 32000, 7), (100, 50, 3)):
        np.testing.assert_array_equal(make_token_stream(n, vocab, seed),
                                      j_token_stream(n, vocab, seed))


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_matches_the_reference_bit_for_bit(moment_dtype):
    """Three steps on a random tree with fresh gradients each step, lr 1e-2
    and weight decay 0.1, against the reference's ``adamw_update`` run
    eagerly: parameters, moments and step equal bit for bit."""
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (33,), "c": (4, 3, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate = j_adamw_init(jp, moment_dtype=getattr(jnp, moment_dtype))
    tstate = adamw_init(tp, moment_dtype=getattr(torch, moment_dtype))
    for _ in range(3):
        grads = {k: (rng.standard_normal(s) * 10.0 ** rng.uniform(-6, 1)
                     ).astype(np.float32) for k, s in shapes.items()}
        with jax.threefry_partitionable(False):
            jp, jstate = j_adamw_update({k: jnp.asarray(g) for k, g in grads.items()},
                                        jstate, jp, 1e-2, weight_decay=0.1)
        tp, tstate = adamw_update({k: torch.from_numpy(g) for k, g in grads.items()},
                                  tstate, tp, 1e-2, weight_decay=0.1)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    for k in shapes:
        np.testing.assert_array_equal(tp[k].numpy().view(np.int32),
                                      np.asarray(jp[k]).view(np.int32), err_msg=k)
        for mom in ("m", "v"):
            np.testing.assert_array_equal(
                tstate[mom][k].float().numpy(),
                np.asarray(jstate[mom][k].astype(jnp.float32)), err_msg=(mom, k))


def _pair(seed=0):
    jcfg = j_get_smoke(ARCH).replace(dtype="float32")
    cfg = get_smoke(ARCH).replace(dtype="float32")
    with jax.threefry_partitionable(False):
        jparams = jtfm.init_lm(jax.random.PRNGKey(seed), jcfg)
    model = ttfm.LM(cfg)
    model.load_state_dict(lm_params_from_numpy(jax.device_get(jparams), cfg,
                                               device="cpu"))
    return jcfg, jparams, cfg, model


def _batches(cfg, n):
    return list(train.make_lm_batches(cfg, BATCH, SEQ, n, device="cpu"))


def test_lm_loss_matches_the_reference():
    jcfg, jparams, cfg, model = _pair()
    batch = _batches(cfg, 1)[0]
    with jax.threefry_partitionable(False):
        jloss, jm = jtfm.lm_loss(jparams, {"tokens": jnp.asarray(batch["tokens"].numpy())},
                                 jcfg)
    with torch.no_grad():
        loss, m = ttfm.lm_loss(model, batch, cfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["xent"]), float(jm["xent"]), rtol=1e-5)
    assert float(m["aux"]) == float(jm["aux"]) == 0.0
    # labels < 0 are masked out, as in the reference
    labels = batch["tokens"].clone()
    labels[:, ::3] = -1
    with jax.threefry_partitionable(False):
        jl, _ = jtfm.lm_loss(jparams, {"tokens": jnp.asarray(batch["tokens"].numpy()),
                                       "labels": jnp.asarray(labels.numpy())}, jcfg)
    with torch.no_grad():
        tl, _ = ttfm.lm_loss(model, dict(batch, labels=labels), cfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def _port_grads(model, cfg, batch) -> dict:
    """The port's gradient of the mean loss over ``batch`` (name -> array)."""
    loss, _ = ttfm.lm_loss(model, batch, cfg)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return _flat(lm_params_to_numpy(
        dict(zip([n for n, _ in model.named_parameters()], grads)), cfg))


def _run_both(microbatches, check_grads=False):
    jcfg, jparams, cfg, model = _pair()
    batches = _batches(cfg, STEPS)
    first = _port_grads(model, cfg, batches[0])
    if check_grads:
        with jax.threefry_partitionable(False):
            jg = jax.grad(lambda p: jtfm.lm_loss(
                p, {"tokens": jnp.asarray(batches[0]["tokens"].numpy())}, jcfg)[0]
            )(jparams)
        jg = _flat(jax.device_get(jg))
        errs = {k: _scale_err(first[k], jg[k]) for k in jg}
        assert max(errs.values()) <= 1e-5, errs
    jstep = jax.jit(jsteps.build_train_step(jcfg, lr=LR, microbatches=microbatches))
    tstep = steps.build_train_step(cfg, lr=LR, microbatches=microbatches)
    jopt = j_adamw_init(jparams)
    topt = adamw_init(dict(model.named_parameters()))
    jl, tl = [], []
    fwd, bwd = flash_ops.flash_attention.launches, flash_ops.flash_attention.backward_calls
    for b in batches:
        with jax.threefry_partitionable(False):
            jparams, jopt, loss = jstep(jparams, jopt,
                                        {"tokens": jnp.asarray(b["tokens"].numpy())})
        jl.append(float(loss))
        model, topt, loss = tstep(model, topt, b)
        tl.append(float(loss))
    # the flash branch ran backward once a layer a microbatch a step, and
    # launched no kernel (CPU tensors)
    assert flash_ops.flash_attention.backward_calls - bwd == \
        STEPS * microbatches * cfg.n_layers
    assert flash_ops.flash_attention.launches == fwd
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    got = _flat(lm_params_to_numpy(dict(model.named_parameters()), cfg))
    want = _flat(jax.device_get(jparams))
    assert sorted(got) == sorted(want)
    errs, moved = {}, {}
    for k in want:
        tiny = (np.abs(first[k]) < 1e-7) & (first[k] != 0)   # 0: unused rows
        assert tiny.mean() <= 5e-3, (k, int(tiny.sum()))
        errs[k] = _scale_err(got[k][~tiny], want[k][~tiny])
        if tiny.any():
            moved[k] = float(np.abs(got[k][tiny] - want[k][tiny]).max())
    assert max(errs.values()) <= 1e-5, errs
    assert max(moved.values(), default=0.0) <= STEPS * LR, moved
    jo = adamw_state_to_numpy(topt, cfg)
    assert int(jo["step"]) == int(jopt["step"]) == STEPS


def test_train_step_matches_the_reference():
    """Three AdamW steps at S = 2048 (the flash branch), remat on; the first
    step's gradients against ``jax.grad`` of the reference's loss."""
    _run_both(1, check_grads=True)


def test_input_specs_and_shapes_are_meta_tensors():
    cfg = get_smoke(ARCH)
    with jax.threefry_partitionable(False):
        jp = jsteps.params_shape(j_get_smoke(ARCH))
        jo = jsteps.opt_shape(jp)
    p = steps.params_shape(cfg)
    assert all(t.device.type == "meta" for t in p.values())
    want = {k: v.shape for k, v in _flat(jax.tree_util.tree_map(
        lambda s: np.empty(s.shape, np.float32), jp)).items()}
    got = {k: v.shape for k, v in _flat(lm_params_to_numpy(
        {k: torch.empty(t.shape) for k, t in p.items()}, cfg)).items()}
    assert got == want
    o = steps.opt_shape(p)
    assert set(o) == set(jo) and all(t.device.type == "meta" for t in o["m"].values())
    spec = steps.input_specs(ARCH, "train_4k", cfg)
    assert spec["tokens"].shape == (256, 4096) and spec["tokens"].dtype == torch.int32
    dec = steps.input_specs(ARCH, "decode_32k", cfg)
    assert dec["token"].shape == (128, 1) and dec["pos"].shape == ()
    assert dec["cache"]["layers"][0]["k"].device.type == "meta"
    cnn = steps.params_shape(get_smoke("fmnist-cnn"))
    assert all(t.device.type == "meta" for t in cnn.values())


def test_adamw_state_converts_both_ways():
    _, jparams, cfg, model = _pair()
    st = adamw_init(dict(model.named_parameters()))
    for k, t in st["m"].items():
        t.normal_()
    back = adamw_state_from_numpy(adamw_state_to_numpy(st, cfg), cfg, device="cpu")
    for mom in ("m", "v"):
        assert all(torch.equal(back[mom][k], st[mom][k]) for k in st[mom])
    assert int(back["step"]) == 0


def test_train_cli_learns_on_the_cpu(capsys):
    losses = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--steps", "20", "--batch", "4", "--seq", "64"])
    assert len(losses) == 20 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert "loss" in capsys.readouterr().out
