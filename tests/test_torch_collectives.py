"""Cross-silo aggregation (``repro_torch.fl.collectives``) on spawned gloo
ranks against the JAX package.

Meshes ``(pod, data, model)`` = (2, 2, 1) and (2, 1, 2); pod p's silo
update is its own numpy draw, split over the silo's ranks, so every rank
holds a different shard. Per rank: ``make_fl_allreduce`` (and
``compressed_psum_update``) equal the mean over pods of the JAX
``block_topk(use_pallas=True)`` of each pod's shard at that position
(fp32, atol 1e-7); the sparse exchange agrees with the dense one to 1e-6
and its int8 version to 0.02 of the largest aggregate coordinate, the
bounds of ``tests/test_system.py::test_sparse_crosspod_aggregation``;
``silo_update_norm`` equals numpy's norm of the whole silo update (rtol
1e-5). The ``launch.multipod`` CLI runs on the CPU.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from repro.fl.compression import block_topk as j_block_topk

from repro_torch.fl.collectives import make_silo_mesh
from torch_dist import collectives_body, spawn

ROOT = os.path.join(os.path.dirname(__file__), "..")
GAMMA, N = 0.25, 1 << 16


@pytest.fixture(scope="module", params=[(2, 2, 1), (2, 1, 2)],
                ids=["pods2_data2", "pods2_model2"])
def mesh_run(request, tmp_path_factory):
    shape = request.param
    vecs = np.random.default_rng(11).normal(size=(shape[0], N)).astype(np.float32)
    out = tmp_path_factory.mktemp("collectives")
    return shape, vecs, spawn(collectives_body, int(np.prod(shape)), out,
                              shape, vecs, GAMMA, out)


def _shard(vec, shape, data, model):
    m = N // (shape[1] * shape[2])
    i = data * shape[2] + model
    return vec[i * m:(i + 1) * m]


def test_dense_exchange_is_the_pod_mean_of_the_reference(mesh_run):
    shape, vecs, ranks = mesh_run
    seen = set()
    for r in ranks:
        _, d, m = (int(c) for c in r["coords"])
        seen.add(tuple(int(c) for c in r["coords"]))
        want = np.mean([np.asarray(j_block_topk(
            jnp.asarray(_shard(v, shape, d, m)), GAMMA, use_pallas=True)[0])
            for v in vecs], axis=0)
        np.testing.assert_allclose(r["dense"], want, rtol=0, atol=1e-7)
        np.testing.assert_array_equal(r["psum"], r["dense"])
        assert int(r["bytes"][0]) == 4 * r["dense"].size
    assert len(seen) == len(ranks)


def test_sparse_exchanges_agree_with_the_dense_one(mesh_run):
    shape, _, ranks = mesh_run
    scale = max(float(np.abs(r["dense"]).max()) for r in ranks)
    rel = max(float(np.abs(r["int8"] - r["dense"]).max()) for r in ranks) / scale
    assert rel < 0.02, rel
    for r in ranks:
        np.testing.assert_allclose(r["sparse"], r["dense"], rtol=0, atol=1e-6)
        nb, k = r["dense"].size // 4096, 1024
        # values + int16 indices gathered from both pods; int8 + one scale
        assert int(r["bytes"][1]) == shape[0] * nb * k * (4 + 2)
        assert int(r["bytes"][2]) == shape[0] * (nb * k * (1 + 2) + 4)


def test_silo_update_norm_is_the_whole_update_norm(mesh_run):
    _, vecs, ranks = mesh_run
    for r in ranks:
        p = int(r["coords"][0])
        want = np.sqrt(np.sum(vecs[p].astype(np.float64) ** 2))
        np.testing.assert_allclose(float(r["norm"]), want, rtol=1e-5)


def test_silo_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_silo_mesh(2, device="cpu")


def test_multipod_cli_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.multipod", "--device", "cpu",
         "--pods", "2", "--data", "2", "--model", "1", "--n", str(N)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0] == f"update: {N} coords, gamma={GAMMA}, 4 ranks on cpu"
    assert "62% fewer" in lines[2]
    assert float(lines[3].rsplit(" ", 1)[1]) < 0.02
