"""Hierarchical control (``repro_torch.core.hierarchy``) against the JAX
package: the config, the host k-means, the cluster-stratified deficit
weights, the Gumbel top-k pools, the ``SampledController`` decide path
(pools, decisions, the non-candidates' ``q`` decay and frozen ``mu``,
``reset_clients``), and the sampled trainer on the 12-round MLP of
``tests/test_scan_engine.make_trainer``: live reference runs with
clusters 2 and pool_frac 0.5 (plain, with the joint bits grid, with
churn), the disabled config, checkpoints (the port's, and the reference's
restored in the port), ``run_sweep``'s seed lanes, and the (2, 2)
``(clusters, clients)`` mesh on 4 gloo ranks against the unsharded run.

Gates: pools (each round's as drawn from that round's state), ``assign``,
masks, gammas and ``bits`` exactly equal;
energies rtol 1e-5; accuracy within 1/128. Reference calls run under
``jax.threefry_partitionable(False)``; inputs come from numpy seeds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import FairEnergyConfig as JFE
from repro.core import faults as jf
from repro.core import hierarchy as jh
from repro.core.controllers import ControllerContext as JCtx
from repro.core.controllers import make_controller as j_make
from repro.core.controllers.base import RoundObservation as JObs

from repro_torch import random as prng
from repro_torch.configs import FairEnergyConfig
from repro_torch.core import faults as tf
from repro_torch.core import hierarchy as th
from repro_torch.core.controllers import ControllerContext, make_controller
from repro_torch.core.controllers import RoundObservation

from test_torch_mobility import assert_main_golden
from test_torch_trainer import ACC_TOL
from torch_dist import (ROUNDS, hierarchy_mesh_body, history_arrays,
                        mlp_data, mlp_trainer, record_pools, spawn)

CFG = dict(clusters=2, pool_frac=0.5)
E_RTOL = 1e-5


# ------------------------------------------------------------- config ----
def test_config_checks_and_resolution_equal_the_reference():
    for kw in (dict(), dict(clusters=4, pool_frac=0.25), dict(pool_size=7),
               dict(clusters=2), dict(pool_frac=0.333), dict(pool_frac=0.5)):
        t, j = th.HierarchyConfig(**kw), jh.HierarchyConfig(**kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        for n in (1, 5, 8, 50, 100, 1000, 1003):
            assert t.resolve_pool(n) == j.resolve_pool(n), (kw, n)
            assert t.sampling_enabled(n) == j.sampling_enabled(n), (kw, n)
    assert th.HierarchyConfig(clusters=4,
                              pool_frac=0.25).resolve_pool(1000) == 250
    for kw in (dict(clusters=0), dict(pool_frac=0.0), dict(pool_frac=1.5),
               dict(pool_size=0), dict(deficit_floor=0.0)):
        with pytest.raises(ValueError):
            th.HierarchyConfig(**kw)


# ------------------------------------------------------------ k-means ----
@pytest.mark.parametrize("n,k,seed", [(40, 4, 7), (1000, 4, 0), (12, 3, 5),
                                      (3, 5, 0)])
def test_kmeans_and_assign_nearest_equal_the_reference(n, k, seed):
    rng = np.random.default_rng(seed)
    args = (rng.uniform(1e-9, 1e-7, n), rng.uniform(0.1, 1.0, n),
            rng.uniform(1e-5, 5e-3, n))
    feats = th.cluster_features(*args)
    np.testing.assert_array_equal(feats, jh.cluster_features(*args))
    a, c = th.kmeans(feats, k, seed=seed)
    ja, jc = jh.kmeans(feats, k, seed=seed)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(c, np.asarray(jc))
    assert a.dtype == np.int32
    if k < n:
        assert set(np.unique(a)) == set(range(k))
        got = th.assign_nearest(torch.tensor(feats, dtype=torch.float32),
                                torch.tensor(c))
        want = jh.assign_nearest(jnp.asarray(feats, jnp.float32),
                                 jnp.asarray(c))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), a)


# ------------------------------------------------------ pool sampling ----
@pytest.mark.parametrize("n,k", [(12, 1), (50, 2), (1000, 4), (2000, 8)])
def test_deficit_weights_bit_for_bit(n, k):
    rng = np.random.default_rng(n + k)
    d = np.maximum(rng.normal(0.05, 0.1, n), 0.0).astype(np.float32)
    a = rng.integers(0, k, n).astype(np.int32)
    want = jax.jit(lambda d, a: jh.deficit_weights(d, a, k, 0.05))(d, a)
    got = th.deficit_weights(torch.tensor(d), torch.tensor(a), k, 0.05)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))


@pytest.mark.parametrize("n", [12, 50, 1000])
def test_pool_indices_equal_the_reference(n):
    w = np.random.default_rng(n).uniform(0.01, 1.0, n).astype(np.float32)
    w[::7] = 0.0
    with jax.threefry_partitionable(False):
        for k_pool in (1, n // 4, n // 2, n):
            for r in (0, 5, 99):
                want = jax.jit(lambda w, r: jh.pool_indices(
                    jax.random.PRNGKey(7), r, w, k_pool))(w, jnp.int32(r))
                got = th.pool_indices(prng.PRNGKey(7), r, torch.tensor(w),
                                      k_pool)
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
                assert (np.diff(got.numpy()) > 0).all()


def test_zero_weights_enter_only_an_underfilled_pool_in_index_order():
    w = np.zeros(20, np.float32)
    w[:5] = 1.0
    with jax.threefry_partitionable(False):
        for k_pool in (5, 8, 20):
            for r in range(4):
                got = th.pool_indices(prng.PRNGKey(0), r, torch.tensor(w),
                                      k_pool).numpy()
                want = jh.pool_indices(jax.random.PRNGKey(0), jnp.int32(r),
                                       jnp.asarray(w), k_pool)
                np.testing.assert_array_equal(got, np.asarray(want))
                np.testing.assert_array_equal(got, np.arange(k_pool))


# ------------------------------------------- the sampled decide path ----
FE_KW = dict(eta=1e-3, eta_auto=False)


def _wrapped_pair(controller="fairenergy", n=12, clusters=3, pool_frac=0.5,
                  seed=0, fe_kw=None):
    """The same wrapper built in both packages (the reference test's
    ``_wrapped`` recipe, with a device profile's e_cmp)."""
    fe_kw = fe_kw or {}
    rng = np.random.default_rng(seed)
    e_cmp = tuple(rng.uniform(1e-5, 5e-3, n))
    common = dict(n_clients=n, b_tot=10e6, s_bits=6.4e7, i_bits=2e6,
                  n0=4e-21, e_cmp=e_cmp)
    jctx = JCtx(fe_cfg=JFE(**FE_KW, **fe_kw), **common)
    tctx = ControllerContext(fe_cfg=FairEnergyConfig(**FE_KW, **fe_kw),
                             device="cpu", **common)
    pl, pw = rng.uniform(1e-9, 1e-7, n), rng.uniform(0.1, 1.0, n)
    jcfg = jh.HierarchyConfig(clusters=clusters, pool_frac=pool_frac)
    tcfg = th.HierarchyConfig(clusters=clusters, pool_frac=pool_frac)
    jw = jh.wrap_controller(j_make(controller, jctx), jcfg, jctx, pathloss=pl,
                            power=pw, base_key=jax.random.PRNGKey(seed + 99),
                            seed=seed)
    tw = th.wrap_controller(make_controller(controller, tctx), tcfg, tctx,
                            pathloss=pl, power=pw,
                            base_key=prng.PRNGKey(seed + 99), seed=seed)
    return jw, tw


def _obs_pair(rng, r, n, alive=None):
    u = rng.uniform(0.1, 2.0, n).astype(np.float32)
    h = rng.uniform(1e-8, 1e-6, n).astype(np.float32)
    P = rng.uniform(0.1, 1.0, n).astype(np.float32)
    jobs = JObs(u_norms=jnp.asarray(u), h=jnp.asarray(h), P=jnp.asarray(P),
                round=jnp.int32(r), key=jax.random.PRNGKey(1000 + r),
                alive=None if alive is None else jnp.asarray(alive))
    tobs = RoundObservation(u_norms=torch.tensor(u), h=torch.tensor(h),
                            P=torch.tensor(P), round=r,
                            key=prng.PRNGKey(1000 + r),
                            alive=(None if alive is None
                                   else torch.tensor(alive)))
    return jobs, tobs


def _assert_decisions_equal(t, j, msg):
    for f in ("x", "gamma"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)),
                                      err_msg=f"{msg} {f}")
    for f in ("bandwidth", "energy", "mu"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=E_RTOL,
                                   atol=1e-12, err_msg=f"{msg} {f}")
    if j.bits is None:
        assert t.bits is None
    else:
        np.testing.assert_array_equal(t.bits.numpy(), np.asarray(j.bits))


@pytest.mark.parametrize("controller,fe_kw", [
    ("fairenergy", None), ("fairenergy", dict(bits_grid=(8.0, 16.0, 32.0))),
    ("tilted", None), ("scoremax", None), ("ecorandom", None)])
def test_sampled_decide_matches_the_reference(controller, fe_kw):
    """Pools (from the state before each decide), decisions priced with
    the pool's e_cmp, the scattered state: the non-candidates' q decays by
    rho and their mu stays frozen (FairEnergy), tilted's score EMA
    gathered and scattered."""
    n = 12
    jw, tw = _wrapped_pair(controller, n=n, fe_kw=fe_kw)
    assert tw.name == jw.name == f"sampled({controller})"
    assert tw.needs_calibration == jw.needs_calibration
    rng = np.random.default_rng(5)
    with jax.threefry_partitionable(False):
        js, ts = jw.init(n), tw.init(n)
        np.testing.assert_array_equal(ts.assign.numpy(), np.asarray(js.assign))
        for r in range(5):
            alive = None if r < 3 else (np.arange(n) % 5 != 0)
            jobs, tobs = _obs_pair(rng, r, n, alive)
            jpool = np.asarray(jw.pool_for(js, jnp.int32(r), jobs.alive))
            tpool = tw.pool_for(ts, r, tobs.alive).numpy()
            np.testing.assert_array_equal(tpool, jpool, err_msg=f"round {r}")
            prev = ts
            jd, js = jw.decide(jobs, js)
            td, ts = tw.decide(tobs, ts)
            _assert_decisions_equal(td, jd, f"round {r}")
            out = np.setdiff1d(np.arange(n), tpool)
            assert not td.x.numpy()[out].any()
            if controller == "fairenergy":
                rho = float(ts.inner.params.rho)
                np.testing.assert_allclose(ts.inner.q.numpy()[out],
                                           rho * prev.inner.q.numpy()[out],
                                           rtol=1e-6)
                np.testing.assert_array_equal(ts.inner.mu.numpy()[out],
                                              prev.inner.mu.numpy()[out])
            for tl, jl in zip(jax.tree_util.tree_leaves(ts.inner),
                              jax.tree_util.tree_leaves(js.inner)):
                np.testing.assert_allclose(np.asarray(tl), np.asarray(jl),
                                           rtol=E_RTOL, atol=1e-12)


def test_reset_clients_forwards_and_reassigns():
    jw, tw = _wrapped_pair(n=12)
    rng = np.random.default_rng(1)
    mask = np.zeros(12, bool)
    mask[[2, 5]] = True
    with jax.threefry_partitionable(False):
        jobs, tobs = _obs_pair(rng, 0, 12)
        _, js = jw.decide(jobs, jw.init(12))
        _, ts = tw.decide(tobs, tw.init(12))
        jn = jw.reset_clients(js, jnp.asarray(mask))
        tn = tw.reset_clients(ts, torch.tensor(mask))
    np.testing.assert_array_equal(tn.assign.numpy(), np.asarray(jn.assign))
    np.testing.assert_array_equal(tn.assign.numpy(), ts.assign.numpy())
    np.testing.assert_allclose(tn.inner.q.numpy()[[2, 5]],
                               float(FairEnergyConfig().q0))
    np.testing.assert_array_equal(tn.inner.mu.numpy()[[2, 5]], 0.0)
    np.testing.assert_allclose(tn.inner.q.numpy(), np.asarray(jn.inner.q),
                               rtol=1e-6)


# ---------------------------------------------------- trainer-level ----
def record_reference_pools(jtr) -> dict:
    """The reference's pools as drawn: its ``pool_for`` runs inside the
    jitted scan, so a debug callback hands each round's indices to the
    host under the round's index; ``pools_in_order`` lists them."""
    drawn = {}
    pool_for = jtr.controller.pool_for

    def keep(r, idx):
        drawn[int(r)] = np.asarray(idx)

    def recording(state, round_idx, alive=None):
        idx = pool_for(state, round_idx, alive)
        jax.debug.callback(keep, round_idx, idx)
        return idx
    jtr.controller.pool_for = recording
    return drawn


def pools_in_order(drawn: dict, start: int = 0) -> list:
    jax.effects_barrier()
    assert sorted(drawn) == list(range(start, start + len(drawn)))
    return [drawn[r] for r in sorted(drawn)]


def _live(jkw=None, tkw=None, cfg=CFG):
    from test_scan_engine import make_trainer
    with jax.threefry_partitionable(False):
        jtr = make_trainer("fairenergy", hierarchy=jh.HierarchyConfig(**cfg),
                           **(jkw or {}))
        jdrawn = record_reference_pools(jtr)
        jtr.run_scanned(ROUNDS, verbose=False)
    ttr = mlp_trainer(mlp_data()[0], hierarchy=th.HierarchyConfig(**cfg),
                      **(tkw or {}))
    tpools = record_pools(ttr)
    ttr.run_scanned(ROUNDS, verbose=False)
    return jtr, pools_in_order(jdrawn), ttr, tpools


def _assert_pools_equal(tpools, jpools, start=0):
    """Every round's pool as each package drew it, round by round."""
    assert len(tpools) == len(jpools)
    for r, (tp, jp) in enumerate(zip(tpools, jpools), start):
        np.testing.assert_array_equal(tp, jp, err_msg=f"pool of round {r}")


def _assert_runs_equal(ttr, jtr):
    assert len(ttr.history) == len(jtr.history)
    for t, j in zip(ttr.history, jtr.history):
        msg = f"round {t.round}"
        np.testing.assert_array_equal(t.selected, np.asarray(j.selected),
                                      err_msg=msg)
        np.testing.assert_array_equal(t.gamma, np.asarray(j.gamma),
                                      err_msg=msg)
        np.testing.assert_allclose(t.energy, np.asarray(j.energy),
                                   rtol=E_RTOL, atol=0, err_msg=msg)
        assert abs(t.accuracy - float(j.accuracy)) <= ACC_TOL, msg
        if j.bits is not None:
            np.testing.assert_array_equal(t.bits, np.asarray(j.bits))
    np.testing.assert_array_equal(ttr.ctrl_state.assign.numpy(),
                                  np.asarray(jtr.ctrl_state.assign))


@pytest.mark.parametrize("case", ["plain", "bits_grid", "churn"])
def test_sampled_trainer_matches_the_live_reference(case):
    jkw, tkw = {}, {}
    if case == "bits_grid":
        jkw = dict(fe_cfg=JFE(bits_grid=(8.0, 16.0, 32.0)))
        tkw = dict(fe_cfg=FairEnergyConfig(bits_grid=(8.0, 16.0, 32.0)))
    elif case == "churn":
        jkw = dict(fault_cfg=jf.FaultConfig(churn_dwell=3, churn_away=0.3))
        tkw = dict(fault_cfg=tf.FaultConfig(churn_dwell=3, churn_away=0.3))
    jtr, jpools, ttr, tpools = _live(jkw, tkw)
    assert ttr.controller.name == "sampled(fairenergy)"
    k_pool = th.HierarchyConfig(**CFG).resolve_pool(ttr.n_clients)
    assert all(lg.n_selected <= k_pool for lg in ttr.history)
    assert any(lg.n_selected > 0 for lg in ttr.history)
    assert len(tpools) == ROUNDS
    _assert_pools_equal(tpools, jpools)
    _assert_runs_equal(ttr, jtr)


def test_disabled_config_is_unwrapped_and_matches_the_main_golden():
    tr = mlp_trainer(mlp_data()[0],
                     hierarchy=th.HierarchyConfig(clusters=1, pool_frac=1.0))
    assert not hasattr(tr.controller, "inner")
    tr.run_scanned(ROUNDS, verbose=False)
    assert_main_golden(tr.history)


def test_checkpoints_resume_with_identical_pools(tmp_path):
    """The port's checkpoint of a sampled run resumes bit for bit; the
    reference's checkpoint of the same run, restored in the port,
    continues the reference's trajectory with identical pools."""
    from test_scan_engine import make_trainer
    cfg = th.HierarchyConfig(**CFG)
    full = mlp_trainer(mlp_data()[0], hierarchy=cfg)
    full_pools = record_pools(full)
    full.run_scanned(ROUNDS, chunk=4, ckpt_dir=str(tmp_path / "t"),
                     verbose=False)
    resumed = mlp_trainer(mlp_data()[0], hierarchy=cfg)
    start = resumed.restore_checkpoint(
        str(tmp_path / "t" / "ckpt_00000004.npz"))
    assert start == 4
    resumed_pools = record_pools(resumed)
    resumed.run_scanned(ROUNDS, chunk=4, start_round=start, verbose=False)
    _assert_pools_equal(resumed_pools, full_pools[4:], start=4)
    for a, b in zip(full.history[4:], resumed.history):
        np.testing.assert_array_equal(a.selected, b.selected)
        np.testing.assert_array_equal(a.energy, b.energy)
        assert a.accuracy == b.accuracy
    for k in full.params:
        torch.testing.assert_close(full.params[k], resumed.params[k],
                                   rtol=0, atol=0)
    with jax.threefry_partitionable(False):
        jtr = make_trainer("fairenergy", hierarchy=jh.HierarchyConfig(**CFG))
        jdrawn = record_reference_pools(jtr)
        jtr.run_scanned(ROUNDS, chunk=4, ckpt_dir=str(tmp_path / "j"),
                        verbose=False)
    jpools = pools_in_order(jdrawn)
    _assert_pools_equal(full_pools, jpools)
    cross = mlp_trainer(mlp_data()[0], hierarchy=cfg)
    start = cross.restore_checkpoint(str(tmp_path / "j" / "ckpt_00000004.npz"))
    np.testing.assert_array_equal(cross.ctrl_state.key.numpy(),
                                  full.ctrl_state.key.numpy())
    cross_pools = record_pools(cross)
    cross.run_scanned(ROUNDS, chunk=4, start_round=start, verbose=False)
    _assert_pools_equal(cross_pools, jpools[4:], start=4)
    for t, j in zip(cross.history, jtr.history[4:]):
        np.testing.assert_array_equal(t.selected, np.asarray(j.selected))
        np.testing.assert_allclose(t.energy, np.asarray(j.energy),
                                   rtol=E_RTOL, atol=0)


def test_run_sweep_seed_lanes_share_the_sampler_key():
    """The sampler key lives in the controller state every lane starts
    from, so the seed lanes share it (the reference's documented
    semantics); each lane's masks equal the reference's lane's, and the
    trainer's own seed's lane equals its run_scanned."""
    from test_scan_engine import make_trainer
    seeds = [0, 1]
    with jax.threefry_partitionable(False):
        jtr = make_trainer("fairenergy", hierarchy=jh.HierarchyConfig(**CFG))
        jout = jtr.run_sweep(seeds, ROUNDS)
    ttr = mlp_trainer(mlp_data()[0], hierarchy=th.HierarchyConfig(**CFG))
    tout = ttr.run_sweep(seeds, ROUNDS)
    np.testing.assert_array_equal(tout["x"], np.asarray(jout["x"]))
    np.testing.assert_allclose(tout["energy"], np.asarray(jout["energy"]),
                               rtol=E_RTOL, atol=0)
    ttr.run_scanned(ROUNDS, verbose=False)
    np.testing.assert_array_equal(
        tout["x"][0], np.stack([lg.selected for lg in ttr.history]))


def test_hierarchy_mesh_on_four_ranks_equals_the_unsharded_run(tmp_path):
    """The sampled trainer on the (2, 2) (clusters, clients) mesh of 4
    gloo ranks (two all-reduce stages, lanes cluster-major): pools,
    assign, masks and params equal the unsharded run's bit for bit."""
    cfg = th.HierarchyConfig(**CFG)
    ref = mlp_trainer(mlp_data()[0], hierarchy=cfg)
    drawn = record_pools(ref)
    ref.run_scanned(ROUNDS, verbose=False)
    want = history_arrays(ref)
    pools = np.stack(drawn)
    assert len(pools) == ROUNDS
    outs = spawn(hierarchy_mesh_body, 4, tmp_path, mlp_data()[0], CFG,
                 str(tmp_path), timeout=240.0)
    for rank, got in enumerate(outs):
        assert tuple(got["mesh_shape"]) == (2, 2)
        np.testing.assert_array_equal(got["pools"], pools, err_msg=rank)
        np.testing.assert_array_equal(got["assign"],
                                      ref.ctrl_state.assign.numpy())
        for k in ("selected", "gamma", "energy", "params", "accuracy"):
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"rank {rank} {k}")
