"""The paper's baselines and the tilted controller
(``repro_torch.core.controllers``) against the JAX package's.

One decision on ``tests/test_controllers.py``'s observation (N = 16):
masks exactly equal, gamma, bandwidth and energy rtol 1e-6. Trajectories
of the golden 12-round MLP recipe (``tests/test_scan_engine.py:
make_trainer``): masks exactly equal, energies rtol 1e-4, accuracy within
1/128. JAX calls run under ``jax.threefry_partitionable(False)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ChannelConfig as JCh, FairEnergyConfig as JFE
from repro.core import controllers as jctl

from repro_torch import random as prng
from repro_torch.configs.base import FairEnergyConfig as TFE
from repro_torch.core import controllers as tctl
from repro_torch.core.controllers.tilted import TiltedState

from torch_dist import ROUNDS, mlp_trainer

N = 16
N0 = JCh().noise_density
B_TOT = 10e6
CTX = dict(n_clients=N, b_tot=B_TOT, s_bits=6.4e7, i_bits=2e6, n0=N0,
           fixed_k=4, eco_gamma=0.1, eco_bandwidth=1e5)
ACC_TOL = 1.0 / 128 + 1e-9
NAMES = ["channelgreedy", "ecorandom", "fairenergy", "randomfull",
         "scoremax", "tilted"]


def _ctxs(**kw):
    j = jctl.ControllerContext(**CTX, fe_cfg=JFE(eta=1e-3, eta_auto=False), **kw)
    t = tctl.ControllerContext(**CTX, fe_cfg=TFE(eta=1e-3, eta_auto=False),
                               device="cpu", **kw)
    return j, t


def _draws(seed=0):
    """``tests/test_controllers.py``'s observation draws."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.5, 5.0, N).astype(np.float32)
    h = (1e-3 * rng.uniform(50, 500, N) ** -3.0
         * rng.exponential(1.0, N)).astype(np.float32)
    P = rng.uniform(1e-4, 3e-4, N).astype(np.float32)
    return u, h, P


def _obs(u, h, P, r=0, seed=0, alive=None):
    jo = jctl.RoundObservation(
        u_norms=jnp.asarray(u), h=jnp.asarray(h), P=jnp.asarray(P),
        round=jnp.int32(r),
        key=jax.random.fold_in(jax.random.PRNGKey(seed), r),
        alive=None if alive is None else jnp.asarray(alive))
    to = tctl.RoundObservation(
        u_norms=torch.tensor(u), h=torch.tensor(h), P=torch.tensor(P),
        round=r, key=prng.fold_in(prng.PRNGKey(seed), r),
        alive=None if alive is None else torch.tensor(alive))
    return jo, to


def _assert_decisions(jd, td, rtol=1e-6, msg=""):
    np.testing.assert_array_equal(td.x.numpy(), np.asarray(jd.x), err_msg=msg)
    for name in ("gamma", "bandwidth", "energy", "bw_used"):
        np.testing.assert_allclose(getattr(td, name).numpy(),
                                   np.asarray(getattr(jd, name)), rtol=rtol,
                                   atol=1e-12, err_msg=f"{name} {msg}")


def test_registry_names_equal_the_reference():
    assert tctl.available_controllers() == jctl.available_controllers() == NAMES


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seed", [0, 3])
def test_decide_matches_reference(name, seed):
    jctx, tctx = _ctxs()
    jc, tc = jctl.make_controller(name, jctx), tctl.make_controller(name, tctx)
    jo, to = _obs(*_draws(seed), seed=seed)
    with jax.threefry_partitionable(False):
        jd, _ = jc.decide(jo, jc.init(N))
    td, _ = tc.decide(to, tc.init(N))
    # fairenergy's dual ascent sums in another order: rtol 1e-5 there, as
    # test_torch_solver.py holds it
    _assert_decisions(jd, td, rtol=1e-5 if name == "fairenergy" else 1e-6,
                      msg=name)
    if name != "fairenergy":
        assert float(td.lam) == 0.0 and int(td.n_inner) == 0
        assert not td.mu.any() and td.bits is None
        assert int(td.x.sum()) == tctx.k


@pytest.mark.parametrize("name", ["scoremax", "ecorandom", "randomfull",
                                  "channelgreedy", "tilted"])
def test_dead_clients_are_demoted(name):
    """Depleted clients rank below every live one: with 12 of 16 alive and
    K = 4, no dead client is selected, as in the reference."""
    alive = np.ones(N, bool)
    alive[[0, 3, 5, 9]] = False
    jctx, tctx = _ctxs()
    jc, tc = jctl.make_controller(name, jctx), tctl.make_controller(name, tctx)
    jo, to = _obs(*_draws(1), seed=1, alive=alive)
    with jax.threefry_partitionable(False):
        jd, _ = jc.decide(jo, jc.init(N))
    td, _ = tc.decide(to, tc.init(N))
    _assert_decisions(jd, td, msg=name)
    assert not td.x.numpy()[~alive].any()


@pytest.mark.parametrize("scores,k", [
    ([3.0, 1.0, 3.0, 5.0, 0.5], 3),
    ([2.0, 2.0, 2.0, 2.0], 2),                        # all ties
    ([1.0, np.nan, 4.0, np.nan, -np.inf, 4.0], 3),    # NaN ranks last
    ([np.nan, np.nan, 0.0], 2),
    ([-np.inf, -np.inf, 1.0, np.inf], 3),
])
def test_topk_mask_ties_and_nan_match_numpy_argsort(scores, k):
    s = np.asarray(scores, np.float32)
    want = np.zeros(s.size, bool)
    want[np.argsort(-s, kind="stable")[:k]] = True
    np.testing.assert_array_equal(tctl.topk_mask(torch.tensor(s), k).numpy(),
                                  want)
    np.testing.assert_array_equal(np.asarray(jctl.topk_mask(jnp.asarray(s), k)),
                                  want)


def test_eco_bandwidth_zero_is_honoured():
    base = dict(n_clients=N, b_tot=B_TOT, s_bits=6.4e7, i_bits=2e6, n0=N0,
                fixed_k=4, device="cpu")
    assert tctl.ControllerContext(**base, eco_bandwidth=0.0).eco_bw == 0.0
    assert tctl.ControllerContext(**base).eco_bw == pytest.approx(B_TOT / 4)
    assert tctl.ControllerContext(**dict(base, fixed_k=None)).k == N // 5


def test_tilted_over_rounds_with_reset_clients():
    """Five rounds of the tilted controller carrying its score EMA, with
    ``reset_clients`` after round 2, against the reference's."""
    jctx, tctx = _ctxs()
    jc, tc = jctl.make_controller("tilted", jctx), tctl.make_controller("tilted", tctx)
    js, ts = jc.init(N), tc.init(N)
    assert isinstance(ts, TiltedState)
    rng = np.random.default_rng(4)
    _, h, P = _draws(4)
    mask = np.zeros(N, bool)
    mask[[1, 7, 8]] = True
    for r in range(5):
        u = rng.uniform(0.5, 5.0, N).astype(np.float32)
        jo, to = _obs(u, h, P, r=r, seed=4)
        with jax.threefry_partitionable(False):
            jd, js = jc.decide(jo, js)
        td, ts = tc.decide(to, ts)
        _assert_decisions(jd, td, msg=f"round {r}")
        np.testing.assert_allclose(ts.s.numpy(), np.asarray(js.s), rtol=1e-6)
        if r == 2:
            js = jc.reset_clients(js, jnp.asarray(mask))
            ts = tc.reset_clients(ts, torch.tensor(mask))
            assert not ts.s.numpy()[mask].any()


# ------------------------------------------- the 12-round MLP recipe ----
@pytest.mark.parametrize("name,kw", [
    ("scoremax", {"fixed_k": 3}),
    ("ecorandom", {"eco_gamma": 0.1, "eco_bandwidth": 2e5}),
    ("tilted", {}),
])
def test_mlp_trajectory_matches_reference(name, kw):
    from test_scan_engine import make_trainer
    with jax.threefry_partitionable(False):
        jtr = make_trainer(name, **kw)
        params0 = jax.tree_util.tree_map(np.asarray, jtr.params)
        jtr.run_scanned(ROUNDS, verbose=False)
    ttr = mlp_trainer(params0, strategy=name, **kw)
    assert ttr.controller_name == name
    ttr.run_scanned(ROUNDS, verbose=False)
    assert len(ttr.history) == len(jtr.history) == ROUNDS
    for t, j in zip(ttr.history, jtr.history):
        msg = f"{name} round {t.round}"
        np.testing.assert_array_equal(t.selected, np.asarray(j.selected),
                                      err_msg=msg)
        np.testing.assert_array_equal(t.gamma, np.asarray(j.gamma), err_msg=msg)
        np.testing.assert_allclose(t.energy, np.asarray(j.energy), rtol=1e-4,
                                   atol=0, err_msg=msg)
        assert abs(t.accuracy - float(j.accuracy)) <= ACC_TOL, msg
