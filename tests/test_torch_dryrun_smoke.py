"""The dry-run's counts at the smoke TinyLlama on a (2, 2) ``("data",
"model")`` fake mesh, where every dim of the plan divides, and its dispatch
mode on a chain counted by hand.

* Flops: one device's count times 4 equals ``FlopCounterMode``'s count of
  the same train step unsharded (plain ``meta`` tensors): every matmul
  splits four ways and none is repeated.
* Microbatches: with M = 2 (``REPRO_FORCE_MICRO``) the default run (the
  first microbatch counted twice, AdamW once) against ``--full-loop``:
  flops and collectives equal; bytes and memory as the loop's extra
  gradient sums allow.
* ``StepCost`` on plain tensors: a chain whose peak and live bytes are
  known by hand, views holding their storage alive.
* ``constrain`` on a DTensor inside ``activation_rules`` redistributes it
  (a subprocess: the fake process group is process-wide).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_smoke
from repro_torch.launch import dryrun, steps
from repro_torch.optim import adamw_init

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ("--arch", "tinyllama-1.1b", "--shape", "train_4k", "--smoke", "--mesh", "2x2")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_cli(tmp_path, *args, env=None) -> dict:
    out = tmp_path / "out"
    e = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
             **(env or {}))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                        "--out", str(out)], capture_output=True, text=True,
                       env=e, cwd=str(ROOT), timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-6000:]
    (f,) = sorted(out.glob("*.json"))
    return json.loads(f.read_text())


def unsharded_flops(microbatches: int) -> int:
    cfg = get_smoke("tinyllama-1.1b")
    model = steps._meta_model(cfg)
    opt = adamw_init(dict(model.named_parameters()))
    opt["step"] = torch.zeros((), dtype=torch.int32)        # read on the host
    batch = steps.input_specs("tinyllama-1.1b", "train_4k", cfg)
    step = steps.build_train_step(cfg, microbatches=microbatches)
    with FlopCounterMode(display=False) as fc:
        step(model, opt, batch)
    return fc.get_total_flops()


def test_flops_a_device_times_four_equal_the_unsharded_step(tmp_path):
    res = run_cli(tmp_path, *SMOKE)
    assert res["mesh"] == "2x2" and res["n_devices"] == 4
    assert res["microbatches"] == 1
    want = unsharded_flops(1)
    assert want > 0
    assert res["flops_per_device"] * 4 == want


def test_counted_microbatch_against_the_full_loop(tmp_path):
    env = {"REPRO_FORCE_MICRO": "2"}
    one = run_cli(tmp_path / "a", *SMOKE, env=env)
    full = run_cli(tmp_path / "b", *SMOKE, "--full-loop", env=env)
    assert one["microbatches"] == full["microbatches"] == 2
    assert one["flops_per_device"] == full["flops_per_device"]
    assert one["flops_per_device"] * 4 == unsharded_flops(2)
    assert one["collectives"]["counts"] == full["collectives"]["counts"]
    assert one["collectives"]["bytes"] == full["collectives"]["bytes"]
    # the loop adds the second microbatch's gradients to the first's
    # (autograd's accumulation: a read of each and a write a parameter, and
    # a copy where it does not add in place), beyond the counted slice;
    # measured 3.5 parameter bytes a parameter
    p_bytes = full["memory"]["argument_bytes"] // 3          # params, m, v
    extra = full["bytes_accessed_per_device"] - one["bytes_accessed_per_device"]
    assert 0 <= extra <= 4 * p_bytes
    assert one["memory"]["argument_bytes"] == full["memory"]["argument_bytes"]
    assert 0 <= full["memory"]["temp_bytes"] - one["memory"]["temp_bytes"] <= p_bytes


def test_step_cost_counts_a_chain_by_hand():
    cost = dryrun.StepCost()
    with cost:
        a = torch.zeros(1000)                   # 4,000 bytes live
        b = a + 1                               # 8,000
        del a                                   # 4,000
        c = b * 2                               # 8,000: the peak
        d = c.view(10, 100)                     # a view: no bytes
        del b, c                                # d keeps c's storage: 4,000
        e = d.sum()                             # 4,004
        live_at_end = cost.current
        del d                                   # 4
    assert cost.peak == 8000
    assert live_at_end == 4004
    assert cost.current == 4
    assert float(e) == 2000.0
    # operand + result bytes of the ops that move data (zeros, add, mul,
    # sum); the view moves none
    assert cost.bytes_accessed == 4000 + 8000 + 8000 + 4004
    assert cost.flops == 0
    with dryrun.StepCost() as mm:
        torch.randn(8, 16) @ torch.randn(16, 4)
    assert mm.flops == 2 * 8 * 16 * 4


def test_constrain_redistributes_a_dtensor_on_a_fake_mesh():
    code = """
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch.mesh import fake_mesh
from repro_torch.sharding import act
with fake_mesh((2, 2), ("data", "model")) as mesh:
    x = DTensor.from_local(torch.empty(4, 8, 16, device="meta"), mesh,
                           [Replicate(), Replicate()], run_check=False)
    with act.activation_rules(mesh, batch="data", seq_tp="model"):
        y = act.constrain(x, "batch", "seq_tp", None)
        z = act.constrain(x, "batch", None, "heads")     # no rule: replicated
    assert list(y.placements) == [Shard(0), Shard(1)], y.placements
    assert tuple(y.to_local().shape) == (2, 4, 16)
    assert list(z.placements) == [Shard(0), Replicate()]
    # a view into 3 heads of a dim sharded 2 ways replicates it first
    w = DTensor.from_local(torch.empty(4, 12, device="meta"), mesh,
                           [Replicate(), Shard(1)], run_check=False)
    h = act.split_last(w, 3, 8)
    assert tuple(h.shape) == (4, 3, 8) and list(h.placements) == [Replicate(), Replicate()]
    g = act.split_last(w, 2, 12)
    assert list(g.placements) == [Replicate(), Shard(1)]
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                       cwd=str(ROOT), timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stdout + r.stderr
