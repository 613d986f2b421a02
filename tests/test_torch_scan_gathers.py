"""The recurrent scans under the sharding plan: one redistribution a
tensor a layer, however many chunks (ROADMAP C-28).

Each case runs in a subprocess, as ``test_torch_dryrun.py`` runs the
dry-run: the fake process group is process-wide. On a (2, 2) ``("data",
"model")`` fake mesh the smoke zamba2's first Mamba2 layer and the smoke
rwkv6's first time mix run forward on meta DTensors, and
``launch.dryrun.StepCost`` counts the collectives.
The layer's input is laid out as the dry-run's prefill hands it on (the
batch over ``data``, a partial sum over ``model``), which with a batch
of 2 puts the model axis on the sequence inside the layer (the plan's
``seq_tp`` layout). At a fixed S = 256 the bytes must be the same for
chunks of S / 2 and S / 8: a scan that sliced its sequence-sharded
inputs chunk by chunk would gather them once a chunk, four times as
often at S / 8.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
S = 256
ARCHS = ("zamba2-2.7b", "rwkv6-1.6b")

CHILD = r"""
import json, sys
import torch
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_smoke
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import fake_mesh
from repro_torch.models import rwkv, ssm
from repro_torch.sharding.act import activation_rules, contiguous_stride
from torch.distributed.tensor import DTensor, Partial, Shard
from repro_torch.sharding.specs import param_specs

S = int(sys.argv[1])
out = {}
for arch, chunk in [(a, c) for a in sys.argv[2:] for c in (S // 2, S // 8)]:
    cfg = get_smoke(arch)
    if arch == "zamba2-2.7b":
        cfg = cfg.replace(ssm_chunk=chunk)
    with fake_mesh((2, 2), ("data", "model")) as mesh:
        model = steps._meta_model(cfg)
        specs = param_specs(dict(model.named_parameters()), mesh, tp="model")
        dryrun._distribute_model(model, specs, mesh)
        # the layer's input as the dry-run's prefill hands it on: the batch
        # over "data" and the previous layer's row-parallel output still a
        # partial sum over "model"; with a batch of 2 (not a multiple of
        # the 4 ranks) the input projection's reduce-scatter lands on the
        # sequence, as on the production 16 x 16 mesh at batch 32
        shape = (2, S, cfg.d_model)
        x = DTensor.from_local(torch.empty((1, S, cfg.d_model), device="meta"),
                               mesh, [Shard(0), Partial()], run_check=False,
                               shape=shape, stride=contiguous_stride(shape))
        cost = dryrun.StepCost()
        with activation_rules(mesh, batch="data", heads="model", ff="model",
                              seq_tp="model"), implicit_replication(), \
                torch.no_grad(), cost:
            if arch == "zamba2-2.7b":
                y = ssm.mamba2_forward(model.layers[0].mamba, x, cfg)
            else:
                y = rwkv.rwkv6_forward(model.layers[0].time, x, cfg,
                                       chunk=chunk)
        assert tuple(y.shape) == (2, S, cfg.d_model)
        out.setdefault(arch, {})[chunk] = cost.collectives()
print(json.dumps(out))
"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def collectives() -> dict:
    """arch -> chunk -> the layer's collectives, both archs in one child."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", CHILD, str(S), *ARCHS],
                       capture_output=True, text=True, env=env, cwd=str(ROOT),
                       timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-6000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    return {a: {int(k): v for k, v in c.items()} for a, c in got.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_a_layer_gathers_its_sequence_once_whatever_the_chunk(collectives, arch):
    half, eighth = collectives[arch][S // 2], collectives[arch][S // 8]
    # the plan shards the sequence: the layer's input is redistributed
    assert half["total_bytes"] > 0
    assert eighth["total_bytes"] == half["total_bytes"], (half, eighth)
    assert eighth["counts"] == half["counts"], (half, eighth)
