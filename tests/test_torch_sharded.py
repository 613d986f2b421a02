"""Client-axis sharding of the port's trainer (``repro_torch.sharding``,
``FederatedTrainer(mesh=...)``) against the JAX package and the port's
unsharded run.

Ghost padding and the padded sample keys equal the JAX package's
(``tests/test_sharded_engine.py``). The 8-client golden MLP sharded over 2
and 4 gloo ranks reproduces ``fairenergy_main_12round.json`` to the
port's tolerances (masks and gammas exact, energies rtol 1e-4, accuracy
within 1/128). Against the unsharded port run (N = 8, N = 6 with two ghost
clients, and the quantized scenario on the bursty link): masks, gammas,
widths and retransmissions exact, energies rtol 1e-5 and params atol 1e-6
— the partial sums are added in another order, as in the JAX package's
own equivalence test. Every rank holds the same logs and params.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.data import client_sample_keys as j_sample_keys
from repro.data import stack_client_datasets as j_stack

from repro_torch import random as prng
from repro_torch.configs import FairEnergyConfig
from repro_torch.data import client_sample_keys, stack_client_datasets
from repro_torch.scenarios import get_scenario
from repro_torch.sharding import (client_shard_count, clients_axis_size,
                                  make_clients_mesh, make_hierarchy_mesh,
                                  shard_client_data)

from test_torch_trainer import ACC_TOL
from torch_dist import (ROUNDS, history_arrays, mlp_data, mlp_trainer,
                        sharded_trainer_body, single_rank_group, spawn)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "fairenergy_main_12round.json")


# --------------------------------------------------- data-layer padding ----
def _shards():
    return [{"x": np.full((4 + i, 3), i + 1, np.float32),
             "y": np.full((4 + i,), i, np.int32)} for i in range(5)]


@pytest.mark.parametrize("multiple", [1, 4, 5])
def test_ghost_padding_equals_the_reference(multiple):
    got = stack_client_datasets(_shards(), "cpu", pad_to_multiple=multiple)
    want = j_stack(_shards(), pad_to_multiple=multiple)
    assert got.n_clients == want.n_clients == -(-5 // multiple) * multiple
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    for k in ("x", "y"):
        np.testing.assert_array_equal(got.arrays[k].numpy(),
                                      np.asarray(want.arrays[k]))
    with pytest.raises(ValueError, match="pad_to_multiple"):
        stack_client_datasets(_shards(), "cpu", pad_to_multiple=0)


def test_padded_sample_keys_equal_the_reference():
    with jax.threefry_partitionable(False):
        want = np.asarray(j_sample_keys(jax.random.PRNGKey(3), 2, 5, 8))
        want5 = np.asarray(j_sample_keys(jax.random.PRNGKey(3), 2, 5))
    got = client_sample_keys(prng.PRNGKey(3), 2, 5, 8).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(got[:5], want5.astype(np.int64))
    np.testing.assert_array_equal(
        client_sample_keys(prng.PRNGKey(3), 2, 5).numpy(), got[:5])


# ------------------------------------------------ meshes in this process ----
def test_meshes_need_a_process_group_and_a_gpu_by_default(monkeypatch):
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_clients_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_hierarchy_mesh(2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_clients_mesh()


def test_one_rank_mesh_matches_the_unsharded_run(tmp_path):
    """The sharded round on a one-rank mesh (gather, slice, all-reduce)
    in this process; the mesh helpers' checks."""
    ref = mlp_trainer(mlp_data()[0])
    ref.run_scanned(ROUNDS, verbose=False)
    with single_rank_group(tmp_path):
        with pytest.raises(ValueError, match="2 devices"):
            make_clients_mesh(2, device="cpu")
        mesh = make_clients_mesh(device="cpu")
        assert clients_axis_size(mesh) == client_shard_count(mesh) == 1
        with pytest.raises(ValueError, match="clusters"):
            client_shard_count(mesh, ("clusters", "clients"))
        assert make_hierarchy_mesh(1, device="cpu").mesh_dim_names == (
            "clients",)
        with pytest.raises(ValueError, match="do not divide"):
            make_hierarchy_mesh(2, device="cpu")
        data = stack_client_datasets(_shards(), "cpu")
        assert shard_client_data(data, mesh).n_clients == 5
        tr = mlp_trainer(mlp_data()[0], mesh=mesh)
        tr.run_scanned(ROUNDS, verbose=False)
        from torch.distributed.device_mesh import init_device_mesh
        model = init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
        with pytest.raises(ValueError, match="clients"):
            clients_axis_size(model)
        with pytest.raises(ValueError, match="clients"):
            mlp_trainer(mlp_data()[0], mesh=model)
    _assert_equivalent(history_arrays(ref), history_arrays(tr))


# ----------------------------------------------------- spawned gloo ranks ----
def _quantized_bursty():
    fe = get_scenario("quantized").apply_fe(FairEnergyConfig())
    kw = dict(device_profile=get_scenario("quantized").device_profile(8, seed=0),
              link_cfg=get_scenario("bursty-interference").link_config(
                  price_outage=True))
    return fe, kw


def _cases(world):
    golden = ("golden8", mlp_data()[0], 8, None, {})
    if world == 2:
        return [golden]
    fe, kw = _quantized_bursty()
    return [golden, ("ghost6", mlp_data(6)[0], 6, None, {}),
            ("quantized_bursty", mlp_data()[0], 8, fe, kw)]


def _spawn_cases(world, tmp_path_factory):
    out = tmp_path_factory.mktemp(f"sharded{world}")
    return spawn(sharded_trainer_body, world, out, _cases(world), out)


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return _spawn_cases(2, tmp_path_factory)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return _spawn_cases(4, tmp_path_factory)


def _unsharded(name):
    _, params, n, fe, kw = next(c for c in _cases(4) if c[0] == name)
    tr = mlp_trainer(params, fe, n_clients=n, **kw)
    tr.run_scanned(ROUNDS, verbose=False)
    return history_arrays(tr)


def _case(ranks, name):
    out = {k[len(name) + 1:]: v for k, v in ranks[0].items()
           if k.startswith(name + ".")}
    for r in ranks[1:]:                       # replicated on every rank
        for k, v in out.items():
            np.testing.assert_array_equal(r[f"{name}.{k}"], v, err_msg=k)
    return out


def _assert_equivalent(want, got):
    for k in ("selected", "gamma", "bits", "n_retx", "n_outage"):
        assert (k in want) == (k in got), k
        if k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["selected"].shape == want["selected"].shape  # logs unpadded
    for k in ("energy", "bandwidth", "battery", "accuracy", "loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0,
                                   err_msg=k)
    np.testing.assert_allclose(got["params"], want["params"], rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_golden_mlp_reproduces_the_main_golden(world, request):
    got = _case(request.getfixturevalue(f"ranks{world}"), "golden8")
    assert int(got["n_padded"]) == 8
    g = json.load(open(GOLDEN))
    for r in range(ROUNDS):
        msg = f"{world} ranks, round {r}"
        np.testing.assert_array_equal(got["selected"][r].astype(int),
                                      g["selected"][r], err_msg=msg)
        np.testing.assert_array_equal(got["gamma"][r], np.float32(g["gamma"][r]),
                                      err_msg=msg)
        np.testing.assert_allclose(got["energy"][r], g["energy"][r], rtol=1e-4,
                                   atol=0, err_msg=msg)
        assert abs(got["accuracy"][r] - g["accuracy"][r]) <= ACC_TOL, msg
    _assert_equivalent(_unsharded("golden8"), got)


def test_ghost_clients_equal_the_unsharded_run(ranks4):
    got = _case(ranks4, "ghost6")
    assert int(got["n_padded"]) == 8 and got["selected"].shape == (ROUNDS, 6)
    _assert_equivalent(_unsharded("ghost6"), got)


def test_sharded_quantized_bursty_equals_the_unsharded_run(ranks4):
    got = _case(ranks4, "quantized_bursty")
    assert (got["bits"][got["selected"]] < 32.0).any() and got["n_retx"].sum() > 0
    _assert_equivalent(_unsharded("quantized_bursty"), got)


@pytest.mark.parametrize("world", [2, 4])
def test_shard_client_data_requires_divisibility(world, request):
    msg = str(request.getfixturevalue(f"ranks{world}")[0]["divisibility_error"])
    assert msg == (f"client count {world + 1} does not divide the ('clients',) "
                   f"mesh axes ({world}); stack with pad_to_multiple={world} "
                   "to add ghost clients")
