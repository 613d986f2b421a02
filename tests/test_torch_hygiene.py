"""Import hygiene of the port: ``repro_torch`` and ``chip_smoke.py`` never
import JAX, the JAX package or its ``benchmarks``, and the port's entry
points run on the GPU unless asked for the CPU."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

FORBIDDEN = [re.compile(p, re.MULTILINE) for p in (
    r"^\s*(import|from)\s+jax\b",
    r"^\s*from\s+repro\.",
    r"^\s*from\s+repro\s+import\b",
    r"\bimport\s+repro\b(?!_)",
    r"^\s*(import|from)\s+benchmarks\b",
)]


def _port_modules():
    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def test_every_port_module_imports_without_jax_or_repro():
    mods = _port_modules()
    assert "repro_torch.fl.server" in mods and len(mods) >= 30
    assert {"repro_torch.launch.serve", "repro_torch.models.transformer",
            "repro_torch.kernels.flash_attention.ops",
            "repro_torch.fl.collectives", "repro_torch.sharding.fl",
            "repro_torch.launch.multipod", "repro_torch.launch.experiments",
            "repro_torch.core.gss", "repro_torch.core.controllers.baselines",
            "repro_torch.core.controllers.tilted",
            "repro_torch.core.rounds.config", "repro_torch.core.rounds.timing",
            "repro_torch.core.rounds.staleness",
            "repro_torch.core.rounds.harvest", "repro_torch.core.faults.config",
            "repro_torch.core.faults.inject",
            "repro_torch.core.faults.defense", "repro_torch.checkpoint.ckpt",
            "repro_torch.checkpoint", "repro_torch.launch.mesh",
            "repro_torch.launch.dryrun", "repro_torch.sharding.specs",
            "repro_torch.sharding.act"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro', 'benchmarks'))\n"
            "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        [*PORT.rglob("*.py"),
                                         ROOT / "chip_smoke.py"]))
def test_source_has_no_jax_or_repro_import(path):
    text = (ROOT / path).read_text()
    for pat in FORBIDDEN:
        assert not pat.search(text), f"{path}: {pat.pattern}"


def test_scan_flags_reference_imports_but_not_the_port():
    hits = lambda s: any(p.search(s) for p in FORBIDDEN)  # noqa: E731
    assert hits("import jax.numpy as jnp")
    assert hits("from repro.fl import FederatedTrainer")
    assert hits("from repro import configs")
    assert hits("import repro")
    assert hits("from benchmarks.fl_experiments import run_all")
    assert not hits("import repro_torch")
    assert not hits("from repro_torch.fl import FederatedTrainer")


def test_trainer_without_device_raises_when_no_gpu(monkeypatch):
    from repro_torch.fl.server import FederatedTrainer, resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FederatedTrainer(model_loss=None, model_params={}, client_datasets=[],
                         eval_fn=None, fl_cfg=None, fe_cfg=None, ch_cfg=None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_controller_context_without_device_raises_when_no_gpu(monkeypatch):
    """``make_controller`` is a public entry point: its context, like the
    trainer, means the GPU unless asked for the CPU, and never builds
    state on the CPU silently."""
    from repro_torch.configs import FairEnergyConfig
    from repro_torch.core.controllers import ControllerContext, make_controller
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(n_clients=4, b_tot=10e6, s_bits=6.4e7, i_bits=2e6, n0=4e-21,
              fe_cfg=FairEnergyConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ControllerContext(**kw)
    ctx = ControllerContext(**kw, device="cpu")
    assert ctx.device == torch.device("cpu")
    state = make_controller("fairenergy", ctx).init(4)
    assert state.lam.device.type == "cpu" and state.params.eta.device.type == "cpu"
    assert ctx.e_cmp_array().device.type == "cpu"


def test_no_library_attention_under_the_port():
    """``scaled_dot_product_attention`` is ``chip_smoke.py``'s yardstick
    only: the port's attention is its own kernel or plain PyTorch."""
    hits = [str(p.relative_to(ROOT)) for p in PORT.rglob("*")
            if p.is_file() and p.suffix in (".py", ".cu", ".cuh")
            and "scaled_dot_product_attention" in p.read_text()]
    assert hits == []
    assert "scaled_dot_product_attention" in (ROOT / "chip_smoke.py").read_text()


def test_serve_without_device_raises_when_no_gpu(monkeypatch):
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    from repro_torch.models.transformer import LM
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "tinyllama-1.1b", "--smoke"])
    cfg = get_smoke("tinyllama-1.1b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.generate(cfg, LM(cfg), prompt_len=4, gen=1, batch=1)


def test_mesh_and_weight_entry_points_without_device_raise_when_no_gpu(
        monkeypatch):
    """The clients mesh, the silo mesh, the multipod CLI and the weight
    converters mean the GPU by ``device=None``, like every entry point."""
    from repro_torch.convert import (encdec_params_from_numpy, lm_params_from_numpy,
                                     params_from_numpy)
    from repro_torch.fl.collectives import make_silo_mesh
    from repro_torch.launch import multipod
    from repro_torch.sharding import make_clients_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (make_clients_mesh, lambda: make_silo_mesh(2),
                 lambda: multipod.main(["--pods", "1", "--data", "1",
                                        "--model", "1"]),
                 lambda: params_from_numpy({"w": [1.0]}),
                 lambda: lm_params_from_numpy({"w": [1.0]}, None),
                 lambda: encdec_params_from_numpy({"w": [1.0]}, None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert params_from_numpy({"w": [1.0]}, "cpu")["w"].device.type == "cpu"


def test_experiments_without_device_raise_when_no_gpu(monkeypatch):
    from repro_torch.launch import experiments
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        experiments.build(n_clients=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        experiments.run_all(n_clients=2, rounds=1)


def test_timed_fault_and_checkpoint_entry_points_mean_the_gpu(monkeypatch,
                                                              tmp_path):
    """The timed-round, fault and defense state builders mean the GPU by
    ``device=None``; a checkpoint restores onto the devices of the tree it
    restores into."""
    from repro_torch import checkpoint
    from repro_torch.core import faults, rounds
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: rounds.init_async_state(2, 3),
                 lambda: rounds.harvest_rates(None, 2, 1e-3),
                 faults.init_defense_state,
                 lambda: faults.make_aggregator("defended").init()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    st = rounds.init_async_state(2, 3, device="cpu")
    assert st.buf.device.type == "cpu"
    assert faults.init_defense_state("cpu").tau.device.type == "cpu"
    p = checkpoint.save_checkpoint(str(tmp_path), 1, {"a": st})
    back = checkpoint.restore_checkpoint(p, {"a": st})
    assert back["a"].buf.device.type == "cpu"


def test_importing_the_mesh_and_the_dry_run_starts_no_process_group():
    """As the JAX package's ``launch/mesh.py`` touches no device state when
    imported, importing the port's mesh, dry-run and sharding-plan modules
    starts no process group; ``make_production_mesh`` starts the fake one
    and ``release_production_mesh`` ends it."""
    code = ("import torch.distributed as dist\n"
            "import repro_torch.launch.mesh as mesh, repro_torch.launch.dryrun\n"
            "import repro_torch.sharding.specs, repro_torch.sharding.act\n"
            "assert not dist.is_initialized()\n"
            "m = mesh.make_production_mesh(multi_pod=True)\n"
            "assert dist.is_initialized() and dist.get_world_size() == 512\n"
            "assert m.mesh_dim_names == ('pod', 'data', 'model')\n"
            "assert tuple(m.mesh.shape) == (2, 16, 16)\n"
            "m = mesh.make_production_mesh()\n"
            "assert dist.get_world_size() == 256 and tuple(m.mesh.shape) == (16, 16)\n"
            "mesh.release_production_mesh()\n"
            "assert not dist.is_initialized()\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_host_mesh_without_device_raises_when_no_gpu(monkeypatch):
    from repro_torch.launch.mesh import make_host_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()
