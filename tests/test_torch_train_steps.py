"""Dense LM training against the JAX package, second file (split for
time; see ``test_torch_train.py`` for the setting and the tolerances):
``build_train_step(microbatches=2)`` against the reference's ``lax.scan``
gradient accumulation, and the train CLIs' checkpoints crossing
between the packages both ways.
"""
import jax
import numpy as np

from repro import checkpoint as jck
from repro.configs import get_smoke as j_get_smoke
from repro.models import transformer as jtfm
from repro_torch import checkpoint as tck
from repro_torch.configs import get_smoke
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.launch import train
from repro_torch.models import transformer as ttfm

from test_torch_train import ARCH, _flat, _run_both, one_torch_thread  # noqa: F401


def test_microbatched_train_step_matches_the_reference_scan():
    """microbatches = 2 against the reference's ``lax.scan`` accumulation."""
    _run_both(2)


def test_train_checkpoints_cross_between_the_packages(tmp_path, monkeypatch,
                                                      capsys):
    """The port's CLI saves, the reference restores (and its CLI resumes);
    the reference saves, the port's CLI resumes at its step."""
    cfg = get_smoke(ARCH)
    jcfg = j_get_smoke(ARCH)
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "6",
                "--batch", "4", "--seq", "64", "--ckpt-dir", str(port_dir)])
    path = tck.latest_checkpoint(str(port_dir))
    assert path == tck.checkpoint_path(str(port_dir), 6)
    with jax.threefry_partitionable(False):
        like = jtfm.init_lm(jax.random.PRNGKey(1), jcfg)
    restored = jck.restore_checkpoint(path, like)
    mine = tck.restore_checkpoint(path, lm_params_to_numpy(
        dict(ttfm.LM(cfg).named_parameters()), cfg))
    got, want = _flat(mine), _flat(jax.device_get(restored))
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert jck.load_metadata(path)["step"] == 6
    # the reference's CLI resumes the port's checkpoint
    from repro.launch import train as jtrain
    monkeypatch.setattr("sys.argv", ["train", "--arch", ARCH, "--smoke",
                                     "--steps", "1", "--batch", "2", "--seq",
                                     "32", "--ckpt-dir", str(port_dir),
                                     "--resume"])
    with jax.threefry_partitionable(False):
        jtrain.main()
    assert f"resumed {path} (step 6)" in capsys.readouterr().out
    # the port's CLI resumes a checkpoint the reference wrote
    with jax.threefry_partitionable(False):
        jparams = jtfm.init_lm(jax.random.PRNGKey(3), jcfg)
    jck.save_checkpoint(str(ref_dir), 5, jparams,
                        {"arch": ARCH, "step": 5, "loss": 1.0})
    rpath = jck.latest_checkpoint(str(ref_dir))
    tree = tck.restore_checkpoint(rpath, lm_params_to_numpy(
        dict(ttfm.LM(cfg).named_parameters()), cfg))
    model = ttfm.LM(cfg)
    model.load_state_dict(lm_params_from_numpy(tree, cfg, device="cpu"))
    back = _flat(lm_params_to_numpy(dict(model.named_parameters()), cfg))
    want = _flat(jax.device_get(jparams))
    assert all(np.array_equal(back[k], want[k]) for k in want)
    losses = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--steps", "1", "--batch", "2", "--seq", "32",
                         "--ckpt-dir", str(ref_dir), "--resume"])
    assert f"resumed {rpath} (step 5)" in capsys.readouterr().out
    assert len(losses) == 1 and np.isfinite(losses).all()
