"""The reference's public functions that the port gained last: the engine
factories, the single-client step, the round's batch draw, the channel's
inverse rate, and the update and vector norms, each held against the JAX
package on the CPU.

* ``make_scan_engine`` on the golden MLP reproduces
  ``tests/golden/fairenergy_main_12round.json`` with the gates
  ``test_torch_trainer.py`` holds ``run_scanned`` to (masks and gammas
  equal, energies rtol 1e-4, accuracy within one of 128 eval examples).
* ``make_round_engine`` and ``make_scan_engine`` at ``block=1024``
  against the reference's live engines at the same block: masks and
  gammas equal; bandwidths and energies rtol 1e-4 (the solver's sums run
  in other orders, C-6); parameters after one round rtol 1e-6, after 12
  rounds rtol 1e-4.
* ``make_local_step``/``local_update``: 3 steps of sgd, momentum-sgd and
  AdamW, parameters rtol 1e-6 (AdamW: atol 1e-5 lr, its division by
  sqrt(v) amplifying the gradients' last bits), the momentum state
  threaded.
* ``sample_round_batches`` draws the reference's indices;
  ``bandwidth_from_snr``, ``update_l2_norm`` and ``l2_norm``/``l2_norm_ref``
  equal the reference's to fp32 rtol 1e-6.

Every JAX call runs under ``jax.threefry_partitionable(False)`` (ROADMAP
C-2); inputs are made from seeds with numpy.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.channel import bandwidth_from_snr as j_bandwidth_from_snr
from repro.data import ClientDataset as JClientDataset
from repro.data import sample_round_batches as j_sample_round_batches
from repro.data import stack_client_datasets as j_stack
from repro.fl.client import local_update as j_local_update
from repro.fl.client import make_local_step as j_make_local_step
from repro.fl.server import make_round_engine as j_make_round_engine
from repro.fl.server import make_scan_engine as j_make_scan_engine
from repro.fl.updates import update_l2_norm as j_update_l2_norm
from repro.kernels.score_norm.ops import l2_norm as j_l2_norm
from repro.kernels.score_norm.ref import l2_norm_ref as j_l2_norm_ref

from repro_torch import random as prng
from repro_torch.configs import FairEnergyConfig
from repro_torch.core.channel import bandwidth_from_snr, round_gains
from repro_torch.data.pipeline import (ClientDataset, sample_round_batches,
                                       stack_client_datasets)
from repro_torch.fl.client import local_update, make_local_step
from repro_torch.fl.server import make_round_engine, make_scan_engine
from repro_torch.fl.updates import flatten_update, update_l2_norm
from repro_torch.kernels.score_norm import l2_norm, l2_norm_ref
from repro_torch.kernels.score_norm.ops import l2_norm as l2_norm_ops

from torch_dist import ROUNDS
from torch_dist import mlp_data as _mlp_data
from torch_dist import mlp_trainer as _torch_mlp_trainer

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "fairenergy_main_12round.json")
ACC_TOL = 1.0 / 128 + 1e-9


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _torch_scan(tr, **kw):
    """A 12-round ``make_scan_engine`` program of the port's trainer ``tr``
    (calibrated first, as ``run_scanned`` does) from its live carry."""
    tr._maybe_calibrate(0)
    scan = make_scan_engine(**tr._engine_kwargs(), **kw)
    return scan(tr.params, tr.ctrl_state, tr._battery, tr._astate, tr._fstate,
                tr._lstate, tr._data, tr.keys, 0, ROUNDS - 1, 1, ROUNDS)


# a grid without gamma = 1, so that every selected update is sparsified
# (the golden's clients all pick gamma = 1, and the top-k pass copies
# through at any block width)
SPARSE_GRID = (0.1, 0.25, 0.5)


def _jax_trainer():
    from repro.configs import FairEnergyConfig as JFE
    from test_scan_engine import make_trainer
    jtr = make_trainer("fairenergy", fe_cfg=JFE(gamma_grid=SPARSE_GRID))
    jtr._maybe_calibrate(0)
    return jtr


def _sparse_trainer(params0):
    return _torch_mlp_trainer(params0,
                              FairEnergyConfig(gamma_grid=SPARSE_GRID))


def test_scan_engine_reproduces_main_golden():
    *_, outs = _torch_scan(_torch_mlp_trainer(_mlp_data()[0]))
    g = json.load(open(GOLDEN))
    assert outs["x"].shape[0] == g["rounds"] == ROUNDS
    for r in range(ROUNDS):
        np.testing.assert_array_equal(_np(outs["x"][r]).astype(int),
                                      g["selected"][r], err_msg=f"round {r}")
        np.testing.assert_array_equal(_np(outs["gamma"][r]),
                                      np.float32(g["gamma"][r]),
                                      err_msg=f"round {r}")
        np.testing.assert_allclose(_np(outs["energy"][r]), g["energy"][r],
                                   rtol=1e-4, atol=0, err_msg=f"round {r}")
        assert abs(float(outs["accuracy"][r]) - g["accuracy"][r]) <= ACC_TOL


def test_scan_engine_equals_run_scanned():
    """The engine and ``run_scanned`` drive one round body: equal logs
    and final params, bit for bit."""
    params0 = _mlp_data()[0]
    params, *_, outs = _torch_scan(_torch_mlp_trainer(params0), block=4096)
    tr = _torch_mlp_trainer(params0)
    tr.run_scanned(ROUNDS, verbose=False)
    for r, lg in enumerate(tr.history):
        np.testing.assert_array_equal(_np(outs["x"][r]), lg.selected)
        np.testing.assert_array_equal(_np(outs["energy"][r]), lg.energy)
        np.testing.assert_array_equal(_np(outs["loss"][r]), lg.loss)
    for k in params:
        torch.testing.assert_close(params[k], tr.params[k], rtol=0, atol=0)


def test_scan_engine_at_block_1024_matches_the_reference_engine():
    with jax.threefry_partitionable(False):
        jtr = _jax_trainer()
        params0 = jax.tree_util.tree_map(np.asarray, jtr.params)
        j_scan = jax.jit(j_make_scan_engine(
            **jtr._core_kwargs(), block=1024, client_step=jtr._client_step_raw,
            eval_fn=jtr.eval_fn,
            pathloss=jnp.asarray(jtr.network.pathloss, jnp.float32),
            P=jtr._P, rayleigh=jtr.ch_cfg.rayleigh,
            local_steps=jtr.fl_cfg.local_steps, batch=jtr.fl_cfg.local_batch,
            n_real=jtr.n_clients), static_argnames="n_rounds")
        j_params, *_, j_outs = j_scan(
            jtr.params, jtr.ctrl_state, jtr._battery, jtr._astate,
            jtr._fstate, jtr._lstate, jtr._data, jtr._keys(), jnp.int32(0),
            jnp.int32(ROUNDS - 1), jnp.int32(1), n_rounds=ROUNDS)
    params, *_, outs = _torch_scan(_sparse_trainer(params0), block=1024)
    assert bool(((outs["gamma"] > 0) & (outs["gamma"] < 1)).any())
    for r in range(ROUNDS):
        msg = f"round {r}"
        for k in ("x", "gamma"):
            np.testing.assert_array_equal(_np(outs[k][r]), _np(j_outs[k][r]),
                                          err_msg=f"{msg} {k}")
        for k in ("bandwidth", "energy"):
            np.testing.assert_allclose(_np(outs[k][r]), _np(j_outs[k][r]),
                                       rtol=1e-4, atol=0, err_msg=f"{msg} {k}")
        assert abs(float(outs["accuracy"][r])
                   - float(j_outs["accuracy"][r])) <= ACC_TOL, msg
    for k in params:
        np.testing.assert_allclose(_np(params[k]), _np(j_params[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def round_engines():
    """The reference's calibrated trainer and its round engine at block
    1,024, and the port's trainer from the same weights."""
    with jax.threefry_partitionable(False):
        jtr = _jax_trainer()
        params0 = jax.tree_util.tree_map(np.asarray, jtr.params)
        j_core = j_make_round_engine(**jtr._core_kwargs(), block=1024)
    tr = _sparse_trainer(params0)
    tr._maybe_calibrate(0)
    return jtr, j_core, tr


@pytest.mark.parametrize("battery", [False, True])
def test_round_engine_at_block_1024_matches_the_reference_engine(
        round_engines, battery):
    rng = np.random.default_rng(11)
    jtr, j_core, tr = round_engines
    n, d = tr.n_clients, tr.n_params
    updates = (rng.normal(size=(n, d)) * 1e-2).astype(np.float32)
    u_norms = np.sqrt((updates.astype(np.float64) ** 2).sum(1)).astype(np.float32)
    h = _np(round_gains(tr.keys.fade, tr._pathloss, 3, tr.ch_cfg.rayleigh))
    P = _np(tr._P)
    extra_j = (jnp.full(n, jnp.inf),) if battery else ()
    extra_t = (torch.full((n,), float("inf")),) if battery else ()
    with jax.threefry_partitionable(False):
        j_out = j_core(jtr.params, jnp.asarray(updates), jnp.asarray(u_norms),
                       jnp.asarray(h), jnp.asarray(P), jnp.int32(3),
                       jax.random.PRNGKey(5), jtr.ctrl_state, *extra_j)
    kw = tr._engine_kwargs()
    core = make_round_engine(**{k: kw[k] for k in (
        "controller", "spec", "weights", "server_lr", "fault_rt",
        "aggregator", "physics")}, block=1024)
    t_out = core(tr.params, torch.from_numpy(updates),
                 torch.from_numpy(u_norms), torch.from_numpy(h),
                 torch.from_numpy(P), 3, prng.PRNGKey(5), tr.ctrl_state,
                 *extra_t)
    assert len(t_out) == len(j_out) == (4 if battery else 3)
    (t_params, t_dec, *_), (j_params, j_dec, *_) = t_out, j_out
    assert bool(np.asarray(j_dec.x & (j_dec.gamma < 1)).any())
    for k in ("x", "gamma"):
        np.testing.assert_array_equal(_np(getattr(t_dec, k)),
                                      _np(getattr(j_dec, k)), err_msg=k)
    for k in ("bandwidth", "energy"):
        np.testing.assert_allclose(_np(getattr(t_dec, k)),
                                   _np(getattr(j_dec, k)), rtol=1e-4, atol=0,
                                   err_msg=k)
    for k in t_params:
        np.testing.assert_allclose(_np(t_params[k]), _np(j_params[k]),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
    if battery:
        np.testing.assert_array_equal(_np(t_out[3]), _np(j_out[3]))


# ------------------------------------------------ the single-client step ----
def _mlp_loss_t(p, batch):
    hid = torch.tanh(batch["images"] @ p["w1"])
    ll = torch.log_softmax(hid @ p["w2"], dim=-1)
    loss = -torch.mean(torch.gather(ll, 1, batch["labels"][:, None]))
    return loss, {"nll": loss}


def _mlp_loss_j(p, batch):
    hid = jnp.tanh(batch["images"] @ p["w1"])
    ll = jax.nn.log_softmax(hid @ p["w2"], axis=-1)
    loss = -jnp.mean(jnp.take_along_axis(ll, batch["labels"][:, None], 1))
    return loss, {"nll": loss}


@pytest.mark.parametrize("opt", [("sgd", {}), ("sgd", {"momentum": 0.9}),
                                 ("adamw", {"weight_decay": 0.01})],
                         ids=["sgd", "momentum", "adamw"])
def test_local_update_matches_the_reference(opt):
    name, kw = opt
    rng = np.random.default_rng(3)
    params = {"w1": (rng.normal(size=(12, 16)) * 0.3).astype(np.float32),
              "w2": (rng.normal(size=(16, 5)) * 0.3).astype(np.float32)}
    images = rng.normal(size=(37, 12)).astype(np.float32)
    labels = rng.integers(0, 5, size=37).astype(np.int32)
    with jax.threefry_partitionable(False):
        j_step = j_make_local_step(_mlp_loss_j, 0.1, name, **kw)
        j_delta, j_metrics = j_local_update(
            {k: jnp.asarray(v) for k, v in params.items()},
            JClientDataset(images, labels, 8, seed=4), j_step, 3)
    # AdamW divides by sqrt(v): the gradients' last-bit differences (the
    # reference's jitted XLA against eager PyTorch) come out at ~1e-6 of
    # lr on the smallest parameters, hence atol 1e-5 lr there
    atol = 1e-6 if name == "adamw" else 1e-7
    t_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    t_step = make_local_step(_mlp_loss_t, 0.1, name, **kw)
    t_delta, t_metrics = local_update(t_params, ClientDataset(images, labels, 8,
                                                              seed=4), t_step, 3)
    for k in params:
        # the caller's params are left as they were
        np.testing.assert_array_equal(t_params[k].numpy(), params[k])
        np.testing.assert_allclose(t_delta[k].numpy() + params[k],
                                   np.asarray(j_delta[k]) + params[k],
                                   rtol=1e-6, atol=atol, err_msg=k)
    np.testing.assert_allclose(float(t_metrics["loss"]),
                               float(j_metrics["loss"]), rtol=1e-6)
    # the state threads: one call's state into the next
    b = {"images": images[:8], "labels": labels[:8]}
    p1, s1, _ = t_step(t_params, b)
    p2, s2, _ = t_step(p1, b, s1)
    with jax.threefry_partitionable(False):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        jp1, js1, _ = j_step({k: jnp.asarray(v) for k, v in params.items()}, jb)
        jp2, js2, _ = j_step(jp1, jb, js1)
    for k in params:
        np.testing.assert_allclose(p2[k].numpy(), np.asarray(jp2[k]),
                                   rtol=1e-6, atol=atol, err_msg=k)
    if kw.get("momentum"):
        for k in params:
            np.testing.assert_allclose(s2["m"][k].numpy(),
                                       np.asarray(js2["m"][k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)


# ------------------------------------------------------------ the rest ----
def test_sample_round_batches_draws_the_reference_indices():
    shards = [{"x": np.random.default_rng(i).normal(size=(4 + 3 * i, 2)).astype(np.float32),
               "y": np.arange(4 + 3 * i, dtype=np.int32) + 100 * i} for i in range(5)]
    t_data = stack_client_datasets(shards, "cpu", pad_to_multiple=4)
    with jax.threefry_partitionable(False):
        j_data = j_stack(shards, pad_to_multiple=4)
        key = jax.random.PRNGKey(7)
        for r in (0, 3):
            want = j_sample_round_batches(j_data, key, r, local_steps=2,
                                          batch=8, n_real=5)
            got = sample_round_batches(t_data, prng.PRNGKey(7), r, 2, 8,
                                       n_real=5)
            assert got["y"].shape == (8, 2, 8)
            np.testing.assert_array_equal(got["y"].numpy(), np.asarray(want["y"]))
            np.testing.assert_array_equal(got["x"].numpy(), np.asarray(want["x"]))


def test_bandwidth_from_snr_and_the_norms_match_the_reference():
    rng = np.random.default_rng(1)
    c = rng.uniform(1e3, 1e9, size=64).astype(np.float32)
    t = rng.uniform(1e-3, 1e2, size=64).astype(np.float32)
    np.testing.assert_allclose(
        bandwidth_from_snr(torch.from_numpy(c), torch.from_numpy(t)).numpy(),
        np.asarray(j_bandwidth_from_snr(jnp.asarray(c), jnp.asarray(t))),
        rtol=1e-6)
    tree = {"conv0": {"w": rng.normal(size=(3, 3, 1, 4)).astype(np.float32),
                      "b": rng.normal(size=(4,)).astype(np.float32)},
            "fc": {"w": rng.normal(size=(40, 7)).astype(np.float32)}}
    flat = {"conv0.w": tree["conv0"]["w"], "conv0.b": tree["conv0"]["b"],
            "fc.w": tree["fc"]["w"]}
    got = update_l2_norm({k: torch.from_numpy(v) for k, v in flat.items()})
    np.testing.assert_allclose(float(got), float(j_update_l2_norm(tree)),
                               rtol=1e-6)
    vec = flatten_update({k: torch.from_numpy(v) for k, v in flat.items()})
    np.testing.assert_allclose(float(got), float(torch.linalg.vector_norm(vec)),
                               rtol=1e-6)
    for n, block in ((1, 65536), (100, 65536), (300_001, 65536), (5000, 1024),
                     (70_000, 128)):
        v = rng.normal(size=n).astype(np.float32)
        want = float(j_l2_norm(jnp.asarray(v), block=block))
        np.testing.assert_allclose(float(l2_norm(torch.from_numpy(v), block=block)),
                                   want, rtol=1e-6)
        np.testing.assert_allclose(float(l2_norm_ref(torch.from_numpy(v))),
                                   float(j_l2_norm_ref(jnp.asarray(v))), rtol=1e-6)
    assert l2_norm is l2_norm_ops and l2_norm.launches == 0   # CPU: no kernel
    with pytest.raises(ValueError, match="1 dim"):
        l2_norm(torch.zeros(2, 3))
