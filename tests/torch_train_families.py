"""Shared body of the moe, ssm and hybrid training tests
(``test_torch_train_moe.py``, ``_moe_flash.py``, ``_mixtral_flash.py``,
``_rwkv.py``, ``_hybrid.py``, ``_hybrid_flash.py``): the port's
``build_train_step`` against the reference's jitted train step on
the family's SMOKE config in fp32, from the same weights (carried by
``convert``), as ``test_torch_train.py`` does for the dense family.

Gates: the first step's gradients against ``jax.grad`` of the reference's
loss within 1e-5 of each leaf's scale; the steps' losses at rtol 1e-5;
the parameters within 1e-5 of each leaf's scale on all but at most 0.5%
of the model's elements, and those within 3 lr, the most the steps can
move an element. The exception is AdamW's: its update ``m / (sqrt(v) +
eps)`` normalizes each element's gradient, so an element whose gradients
are small or cancel (a zero-initialized bias, an embedding row a step
barely uses, a gradient below 1e-7) turns a rounding-level gradient
difference into an update difference of a good part of lr, far more than
1e-5 of a weight's scale (measured: 0.01-0.15 lr on 0.01-0.2% of the
elements).
"""
import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke as j_get_smoke
from repro.launch import steps as jsteps
from repro.models import transformer as jtfm
from repro.optim import adamw_init as j_adamw_init
from repro_torch.configs import get_smoke
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.launch import steps, train
from repro_torch.models import transformer as ttfm
from repro_torch.optim import adamw_init

BATCH, STEPS, LR = 2, 3, 3e-4
GRAD_TOL = 1e-5


def scale_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def pair(arch: str, seed: int = 0):
    """(reference cfg, params, port cfg, model) of the fp32 SMOKE config,
    the port's weights converted from the reference's."""
    jcfg = j_get_smoke(arch).replace(dtype="float32")
    cfg = get_smoke(arch).replace(dtype="float32")
    with jax.threefry_partitionable(False):
        jparams = jtfm.init_lm(jax.random.PRNGKey(seed), jcfg)
    model = ttfm.LM(cfg)
    model.load_state_dict(lm_params_from_numpy(jax.device_get(jparams), cfg,
                                               device="cpu"))
    return jcfg, jparams, cfg, model


def run_both(arch: str, seq: int, microbatches: int, check_grads: bool,
             steps_run: int = STEPS, batch: int = BATCH) -> dict:
    """``steps_run`` train steps of both packages on ``batch`` rows;
    returns what was measured."""
    import torch
    jcfg, jparams, cfg, model = pair(arch)
    batches = list(train.make_lm_batches(cfg, batch, seq, steps_run, device="cpu"))
    loss, _ = ttfm.lm_loss(model, batches[0], cfg)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    first = flat(lm_params_to_numpy(dict(zip(names, grads)), cfg))
    out = {}
    if check_grads:
        with jax.threefry_partitionable(False):
            jg = jax.jit(jax.grad(lambda p: jtfm.lm_loss(
                p, {"tokens": jnp.asarray(batches[0]["tokens"].numpy())}, jcfg)[0]
            ))(jparams)
        jg = flat(jax.device_get(jg))
        errs = {k: scale_err(first[k], jg[k]) for k in jg}
        out["grad_err"] = max(errs.values())
        assert out["grad_err"] <= GRAD_TOL, errs
    jstep = jax.jit(jsteps.build_train_step(jcfg, lr=LR, microbatches=microbatches))
    tstep = steps.build_train_step(cfg, lr=LR, microbatches=microbatches)
    jopt = j_adamw_init(jparams)
    topt = adamw_init(dict(model.named_parameters()))
    jl, tl = [], []
    for b in batches:
        with jax.threefry_partitionable(False):
            jparams, jopt, jloss = jstep(jparams, jopt,
                                         {"tokens": jnp.asarray(b["tokens"].numpy())})
        jl.append(float(jloss))
        model, topt, tloss = tstep(model, topt, b)
        tl.append(float(tloss))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert np.isfinite(tl).all(), tl
    got = flat(lm_params_to_numpy(dict(model.named_parameters()), cfg))
    want = flat(jax.device_get(jparams))
    assert sorted(got) == sorted(want)
    errs, far, n = {}, 0, 0
    for k in want:
        d = np.abs(got[k].astype(np.float64) - want[k])
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        out_of = d > 1e-5 * scale
        far += int(out_of.sum())
        n += d.size
        errs[k] = float(d[~out_of].max() / scale) if (~out_of).any() else 0.0
        if out_of.any():
            errs[k + " far/lr"] = float(d[out_of].max() / LR)
            assert d[out_of].max() <= steps_run * LR, (k, float(d.max()))
    assert far <= 5e-3 * n, (far, n, errs)
    assert int(topt["step"]) == int(jopt["step"]) == steps_run
    out.update(losses=tl, params=errs, far=far)
    return out
