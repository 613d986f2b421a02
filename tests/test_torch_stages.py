"""Stage-by-stage parity of the port (``repro_torch``) with the JAX package.

Each stage gets the same inputs, made from a seed with numpy, in both
packages. Tolerances: configs, geometry and sampled indices exact; the
channel functions rtol 1e-6 (a few float32 ulps: PyTorch's and XLA's
log1p differ in the last bit); the smoke CNN's forward, loss and grads
and the batched client step's updates and norms rtol 1e-5 (different
convolution and reduction orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs.fmnist_cnn import SMOKE as J_SMOKE
from repro.core import channel as jch
from repro.data.pipeline import (client_sample_keys as j_client_keys,
                                 sample_client_batches as j_sample,
                                 stack_client_datasets as j_stack)
from repro.fl.client import make_batched_client_step as j_make_step
from repro.fl.updates import flatten_update as j_flatten
from repro.models import cnn as jcnn

from repro_torch import random as prng
from repro_torch.configs import base as tbase
from repro_torch.configs.fmnist_cnn import SMOKE as T_SMOKE
from repro_torch.convert import params_from_numpy
from repro_torch.core import channel as tch
from repro_torch.data.pipeline import (client_sample_keys, sample_client_batches,
                                       stack_client_datasets)
from repro_torch.fl.client import make_batched_client_step
from repro_torch.fl.updates import flatten_update, tree_spec, unflatten_update
from repro_torch.models import CNN, cnn_loss


# ------------------------------------------------------------- configs ----
@pytest.mark.parametrize("name", ["ChannelConfig", "FairEnergyConfig",
                                  "FLConfig"])
def test_config_fields_and_defaults_match(name):
    jf = [(f.name, f.default) for f in dataclasses.fields(getattr(jbase, name))]
    tf = [(f.name, f.default) for f in dataclasses.fields(getattr(tbase, name))]
    assert sorted(jf) == sorted(tf)


def test_model_config_is_a_subset_with_the_same_defaults():
    jf = {f.name: f.default for f in dataclasses.fields(jbase.ModelConfig)}
    for f in dataclasses.fields(tbase.ModelConfig):
        assert f.name in jf
        assert f.default == jf[f.name], f.name
    for name in ("cnn_channels", "cnn_dense", "input_hw", "n_classes"):
        assert getattr(T_SMOKE, name) == getattr(J_SMOKE, name)


# ------------------------------------------------------------- channel ----
def _channel_inputs(n=64, seed=0):
    rng = np.random.default_rng(seed)
    P = rng.uniform(1e-4, 3e-4, n).astype(np.float32)
    h = (1e-3 * rng.uniform(50, 500, n) ** -3.0
         * rng.exponential(1.0, n)).astype(np.float32)
    B = (10.0 ** rng.uniform(-1, 7, n)).astype(np.float32)   # some below 1 Hz
    g = rng.uniform(0.1, 1.0, n).astype(np.float32)
    return P, h, B, g


@pytest.mark.parametrize("fn", ["shannon_rate", "comm_time", "comm_energy",
                                "snr_coeff", "payload_bits"])
def test_channel_functions_match(fn):
    P, h, B, g = _channel_inputs()
    s, i, n0 = np.float32(6.4e7), np.float32(2e6), np.float32(4e-21)
    args = {"shannon_rate": (B, P, h, n0), "snr_coeff": (P, h, n0),
            "payload_bits": (g, s, i),
            "comm_time": (g, B, P, h, s, i, n0),
            "comm_energy": (g, B, P, h, s, i, n0)}[fn]
    want = np.asarray(getattr(jch, fn)(*map(jnp.asarray, args)))
    got = getattr(tch, fn)(*map(torch.as_tensor, args)).numpy()
    if fn in ("comm_time", "comm_energy"):
        below = B < tch.RATE_B_FLOOR_HZ
        assert below.any() and np.isinf(got[below]).all()
        np.testing.assert_array_equal(np.isinf(want), np.isinf(got))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 3])
def test_wireless_network_geometry_exact_and_gains_close(seed):
    cfg_j, cfg_t = jbase.ChannelConfig(n_clients=12), tbase.ChannelConfig(n_clients=12)
    with jax.threefry_partitionable(False):
        nj = jch.WirelessNetwork(cfg_j, seed=seed)
        nt = tch.WirelessNetwork(cfg_t, seed=seed)
        np.testing.assert_array_equal(nj.power, nt.power)
        np.testing.assert_array_equal(nj.pathloss, nt.pathloss)
        for r in [0, 1, 9]:
            np.testing.assert_allclose(nt.gains(r), nj.gains(r), rtol=1e-6)


# ---------------------------------------------------------------- data ----
def _shards(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.normal(size=(10 + 9 * i, 3)).astype(np.float32),
             "y": rng.integers(0, 5, size=10 + 9 * i)} for i in range(n)]


@pytest.mark.parametrize("r", [0, 4])
def test_sampled_batches_are_exactly_equal(r):
    shards = _shards()
    with jax.threefry_partitionable(False):
        jd = j_stack(shards)
        key = jax.random.fold_in(jax.random.PRNGKey(0), 2 << 20)
        want = j_sample(jd.arrays, jd.lengths, j_client_keys(key, r, 6), 2, 16)
    td = stack_client_datasets(shards, "cpu")
    tkey = prng.fold_in(prng.PRNGKey(0), 2 << 20)
    got = sample_client_batches(td.arrays, td.lengths,
                                client_sample_keys(tkey, r, 6), 2, 16)
    for k in ("x", "y"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ----------------------------------------------------------- smoke CNN ----
def _smoke_cnn(seed=0):
    jparams = jcnn.init_cnn(jax.random.PRNGKey(seed), J_SMOKE)
    host = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, params_from_numpy(host, device="cpu"), CNN(T_SMOKE)


def _images(n, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 28, 28, 1)).astype(np.float32),
            rng.integers(0, 10, size=n).astype(np.int32))


def test_smoke_cnn_forward_loss_and_grads_match():
    jparams, tparams, model = _smoke_cnn()
    x, y = _images(16)
    want_logits = jcnn.cnn_forward(jparams, jnp.asarray(x), J_SMOKE)
    got_logits = torch.func.functional_call(model, tparams, (torch.tensor(x),))
    np.testing.assert_allclose(got_logits.detach().numpy(), np.asarray(want_logits),
                               rtol=1e-5, atol=1e-6)
    jb = {"images": jnp.asarray(x), "labels": jnp.asarray(y)}
    tb = {"images": torch.tensor(x), "labels": torch.tensor(y, dtype=torch.int64)}
    (jl, _), jg = jax.value_and_grad(
        lambda p: jcnn.cnn_loss(p, jb, J_SMOKE), has_aux=True)(jparams)
    tg, (tl, _) = torch.func.grad_and_value(cnn_loss(model), has_aux=True)(tparams, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(flatten_update(tg).numpy(),
                               np.asarray(j_flatten(jg)), rtol=1e-5, atol=1e-7)


def test_flattened_params_equal_reference_flatten():
    jparams, tparams, _ = _smoke_cnn()
    flat = flatten_update(tparams)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(j_flatten(jparams)))
    assert flat.shape[0] == 52_138
    back = unflatten_update(flat, tree_spec(tparams))
    for k, v in tparams.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy())
    assert list(tparams)[:3] == ["conv0.b", "conv0.w", "conv1.b"]


def test_batched_client_step_updates_and_norms_match():
    jparams, tparams, model = _smoke_cnn()
    rng = np.random.default_rng(5)
    n, steps, b = 3, 2, 8
    x = rng.normal(size=(n, steps, b, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(n, steps, b)).astype(np.int32)
    j_step = j_make_step(lambda p, bb: jcnn.cnn_loss(p, bb, J_SMOKE), 0.05)
    ju, jn, jl = j_step(jparams, {"images": jnp.asarray(x), "labels": jnp.asarray(y)})
    t_step = make_batched_client_step(cnn_loss(model), 0.05)
    tu, tn, tl = t_step(tparams, {"images": torch.tensor(x),
                                  "labels": torch.tensor(y, dtype=torch.int64)})
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
