"""The port's dry-run CLI at the production meshes, in subprocesses (the
fake process group is process-wide, as the reference's 512 placeholder
devices are; the reference's ``tests/test_sharding.py`` runs its CLI the
same way).

On ``whisper-tiny decode_32k`` (16x16) and ``tinyllama-1.1b train_4k``
(16x16): the JSON's keys are those of the reference's ``dryrun_one``
result (read from its source), and ``argument_bytes`` is the sum, over
every leaf of the step's arguments, of the bytes of one device's shard
under the reference's own specs (``repro.sharding``), computed here from
the reference's shapes and dtypes on a stand-in mesh.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.launch import steps as jsteps
from repro.sharding import cache_specs, data_specs, param_specs

ROOT = Path(__file__).resolve().parents[1]


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_cli(tmp_path, *args, env=None, timeout=600) -> dict:
    """The dry-run CLI in a subprocess; its one JSON result."""
    out = tmp_path / "out"
    e = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
             **(env or {}))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                        "--out", str(out)], capture_output=True, text=True,
                       env=e, cwd=str(ROOT), timeout=timeout)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-6000:]
    files = sorted(out.glob("*.json"))
    assert len(files) == 1, files
    return json.loads(files[0].read_text())


def reference_keys() -> tuple:
    """The keys of the reference's dry-run result and of its memory dict,
    from ``repro/launch/dryrun.py``'s ``dryrun_one``."""
    tree = ast.parse((ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "dryrun_one")
    top, mem = None, None
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            keys = {k.value for k in node.value.keys if isinstance(k, ast.Constant)}
            target = node.targets[0]
            if isinstance(target, ast.Name) and target.id == "result":
                top = keys
            elif isinstance(target, ast.Subscript):
                mem = keys
    coll = None
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == "collective_bytes":
            ret = next(n for n in ast.walk(node) if isinstance(n, ast.Return))
            coll = {k.value for k in ret.value.keys}
    return top | {"memory"}, mem, coll


def shard_bytes(shape, dtype, spec, mesh) -> int:
    """Bytes of one device's shard of a leaf under a PartitionSpec."""
    local = list(shape)
    for d, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        for a in (entry,) if isinstance(entry, str) else entry:
            assert local[d] % mesh.shape[a] == 0
            local[d] //= mesh.shape[a]
    return int(np.prod(local, dtype=np.int64)) * np.dtype(dtype).itemsize


def tree_shard_bytes(tree, specs, mesh) -> int:
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    return sum(shard_bytes(l.shape, l.dtype, s, mesh) for l, s in zip(leaves, spec_leaves))


def reference_argument_bytes(arch: str, shape: str, mesh) -> int:
    """The step's arguments as the reference lays them out: parameters
    (and for train the AdamW moments, by the same specs, and the int32
    step) by ``param_specs``, the batch by ``data_specs``, a decode's cache
    by ``cache_specs``, its token by ``data_specs``, its int32 position
    replicated."""
    cfg = j_get_config(arch)
    s = J_SHAPES[shape]
    p_sds = jsteps.params_shape(cfg)
    ps = param_specs(p_sds, mesh)
    total = tree_shard_bytes(p_sds, ps, mesh)
    spec = jsteps.input_specs(arch, shape, cfg)
    if s.kind == "train":
        total += 2 * tree_shard_bytes(p_sds, ps, mesh) + 4      # m, v, step
        total += tree_shard_bytes(spec, data_specs(spec, mesh, s.global_batch), mesh)
    elif s.kind == "decode":
        total += tree_shard_bytes(spec["cache"], cache_specs(spec["cache"], mesh,
                                                             s.global_batch), mesh)
        total += tree_shard_bytes(spec["token"], data_specs(spec["token"], mesh,
                                                            s.global_batch), mesh)
        total += 4                                              # pos
    else:
        total += tree_shard_bytes(spec, data_specs(spec, mesh, s.global_batch), mesh)
    return total


@pytest.mark.parametrize("arch,shape", [("whisper-tiny", "decode_32k"),
                                        ("tinyllama-1.1b", "train_4k")])
def test_cli_writes_the_reference_keys_and_argument_bytes(tmp_path, arch, shape):
    res = run_cli(tmp_path, "--arch", arch, "--shape", shape)
    top, mem, coll = reference_keys()
    assert set(res) == top
    assert set(res["memory"]) == mem
    assert set(res["collectives"]) == coll
    assert res["mesh"] == "16x16" and res["n_devices"] == 256
    assert res["arch"] == arch and res["shape"] == shape
    assert res["kind"] == J_SHAPES[shape].kind
    assert res["flops_per_device"] > 0 and res["bytes_accessed_per_device"] > 0
    m = res["memory"]
    assert m["argument_bytes"] == reference_argument_bytes(
        arch, shape, FakeMesh({"data": 16, "model": 16}))
    assert m["peak_per_device"] == (m["argument_bytes"] + m["output_bytes"]
                                    + m["temp_bytes"] - m["alias_bytes"])
    if J_SHAPES[shape].kind == "train":
        # the parameters and AdamW state are updated in place (donated)
        assert m["alias_bytes"] == m["argument_bytes"] - 256 // 16 * 4096 * 4
        assert res["collectives"]["counts"]["all-gather"] > 0
    else:
        assert m["alias_bytes"] > 0                     # the cache
    assert res["collectives"]["total_bytes"] == sum(res["collectives"]["bytes"].values())
