"""eta_auto calibration against the JAX package (ROADMAP C-20).

The calibrated eta fixes the price of the score for a whole run, so it
must equal the reference's: the same float32 energies (the reference's
eager ops: a true division of the payload by the rate, XLA's ``log1p``)
and, under mobility, the gains of the reference's eager ``gains(r)``,
whose drift is associated otherwise than the scanned round's. Setting:
the paper channel (``ChannelConfig()``, N = 50), S = 32 D and I = D bits
for the CNN's D = 1,630,090, network seeds 0-39 at rounds 0 and 5,
u ~ U(0.05, 0.5) seeded, with no drift and with the 3 dB one. Gate: eta
equal (``==``), the calibration gains bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ChannelConfig as JCh
from repro.configs.base import FairEnergyConfig as JFE
from repro.core.channel import MobilityConfig as JMob
from repro.core.channel import WirelessNetwork as JNet
from repro.core.channel import comm_energy as j_comm_energy
from repro.core.controllers import ControllerContext as JCtx
from repro.core.controllers import make_controller as j_make
from repro_torch.configs.base import ChannelConfig as TCh
from repro_torch.configs.base import FairEnergyConfig as TFE
from repro_torch.core.channel import MobilityConfig as TMob
from repro_torch.core.channel import WirelessNetwork as TNet
from repro_torch.core.channel import comm_energy_eager
from repro_torch.core.controllers import ControllerContext as TCtx
from repro_torch.core.controllers import make_controller as t_make

D_CNN = 1_630_090
SEEDS = range(40)
ROUNDS = (0, 5)


def _controllers():
    ch = JCh()
    ctx = dict(n_clients=ch.n_clients, b_tot=ch.bandwidth_total,
               s_bits=32.0 * D_CNN, i_bits=float(D_CNN), n0=ch.noise_density)
    return (lambda: j_make("fairenergy", JCtx(**ctx, fe_cfg=JFE())),
            lambda: t_make("fairenergy", TCtx(**ctx, fe_cfg=TFE(), device="cpu")))


@pytest.mark.parametrize("sigma_db", [None, 3.0], ids=["static", "mobility"])
def test_calibrated_eta_equals_the_reference(sigma_db):
    j_new, t_new = _controllers()
    jmob = None if sigma_db is None else JMob(sigma_db=sigma_db)
    tmob = None if sigma_db is None else TMob(sigma_db=sigma_db)
    differ = []
    for seed in SEEDS:
        jnet = JNet(JCh(), seed=seed, mobility=jmob)
        tnet = TNet(TCh(), seed=seed, mobility=tmob)
        u = np.random.default_rng(100 + seed).uniform(
            0.05, 0.5, JCh().n_clients).astype(np.float32)
        for r in ROUNDS:
            with jax.threefry_partitionable(False):
                jh = jnet.gains(r)
            th = tnet.calibration_gains(r)
            np.testing.assert_array_equal(th.view(np.int32),
                                          np.asarray(jh).view(np.int32),
                                          err_msg=f"seed {seed} round {r}")
            jc, tc = j_new(), t_new()
            jc.calibrate(u, jh, jnet.power)
            tc.calibrate(u, th, tnet.power)
            if tc.fe_cfg.eta != jc.fe_cfg.eta:
                differ.append((seed, r, tc.fe_cfg.eta, jc.fe_cfg.eta))
    assert not differ, f"{len(differ)} of {2 * len(SEEDS)} etas differ: {differ[:5]}"


def test_eager_energy_equals_the_reference_bit_for_bit():
    """``comm_energy_eager`` against the reference's eager ``comm_energy``
    on 100k random lanes of the paper's range (P, h, and B = B_tot / N)."""
    rng = np.random.default_rng(3)
    n = 100_000
    P = rng.uniform(1e-4, 3e-4, n).astype(np.float32)
    h = (1e-3 * rng.uniform(50, 500, n) ** -3.0
         * rng.exponential(1.0, n)).astype(np.float32)
    ch = JCh()
    args = (0.5, ch.bandwidth_total / ch.n_clients)
    tail = (32.0 * D_CNN, float(D_CNN), ch.noise_density)
    want = np.asarray(j_comm_energy(*args, jax.numpy.asarray(P),
                                    jax.numpy.asarray(h), *tail))
    got = comm_energy_eager(*args, torch.from_numpy(P), torch.from_numpy(h),
                            *tail).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_the_trainer_calibrates_on_the_eager_gains(monkeypatch):
    """``FederatedTrainer`` hands the controller the network's
    ``calibration_gains(r)`` (not the scanned round's ``gains(r)``)."""
    from torch_dist import mlp_data, mlp_trainer

    seen = []
    orig = TNet.calibration_gains

    def spy(self, r=0):
        h = orig(self, r)
        seen.append((r, h))
        return h

    monkeypatch.setattr(TNet, "calibration_gains", spy)
    params, *_ = mlp_data()
    tr = mlp_trainer(params, mobility=TMob(sigma_db=3.0))
    tr.run_scanned(1, verbose=False)
    assert len(seen) == 1 and seen[0][0] == 0
    np.testing.assert_array_equal(seen[0][1], tr.network.calibration_gains(0))
