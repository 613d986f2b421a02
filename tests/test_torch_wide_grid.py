"""The trainer on a 40-level decision grid against the JAX package: the
golden MLP of ``tests/test_scan_engine.make_trainer`` (``torch_dist``'s
port of it) with ``bits_grid=(4, 8, 16, 32)`` over the default 10 gammas,
which the reference takes as a static tuple of any length and the port's
fused dual-ascent kernel takes since its level table became a device
buffer (here, on the CPU, its plain version runs). Three rounds, the
reference under ``jax.threefry_partitionable(False)``: masks, gammas and
widths exactly equal, energies rtol 1e-5, accuracy within 1/128.
"""
import dataclasses

import jax
import numpy as np

from repro.configs import FairEnergyConfig as JFE

from repro_torch.configs import FairEnergyConfig

from test_torch_trainer import ACC_TOL, _mlp_data, _torch_mlp_trainer

BITS40 = (4.0, 8.0, 16.0, 32.0)
ROUNDS = 3


def test_trainer_on_the_40_level_grid_matches_the_reference():
    from test_scan_engine import make_trainer
    with jax.threefry_partitionable(False):
        jtr = make_trainer("fairenergy", fe_cfg=dataclasses.replace(JFE(), bits_grid=BITS40))
        jtr.run_scanned(ROUNDS, verbose=False)
    ttr = _torch_mlp_trainer(_mlp_data()[0],
                             dataclasses.replace(FairEnergyConfig(), bits_grid=BITS40))
    ttr.run_scanned(ROUNDS, verbose=False)
    assert len(FairEnergyConfig().gamma_grid) * len(BITS40) == 40
    assert len(ttr.history) == len(jtr.history) == ROUNDS
    for t, j in zip(ttr.history, jtr.history):
        msg = f"round {t.round}"
        np.testing.assert_array_equal(t.selected, np.asarray(j.selected), err_msg=msg)
        np.testing.assert_array_equal(t.gamma, np.asarray(j.gamma), err_msg=msg)
        np.testing.assert_array_equal(t.bits, np.asarray(j.bits), err_msg=msg)
        np.testing.assert_allclose(t.energy, np.asarray(j.energy), rtol=1e-5,
                                   atol=0, err_msg=msg)
        assert abs(t.accuracy - float(j.accuracy)) <= ACC_TOL, msg
    sel_bits = np.concatenate([t.bits[t.selected] for t in ttr.history])
    assert set(sel_bits.tolist()) <= set(BITS40) and (sel_bits < 32.0).any()
