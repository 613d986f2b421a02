"""The fused dual ascent's plain version and wrapper
(``repro_torch.kernels.dual_solve``: ``dual_ascent_ref``, ``dual_ascent``)
against the JAX package's ``solve_round``, and the CPU-side pieces of the
fused CUDA kernel: its argument packing and the combine rule of its
shuffle argmin.

``dual_ascent_ref`` is Algorithm 1's host loop; on the CPU the wrapper
runs it, so ``solve_round`` reproduces the reference's duals, iteration
counts and masks exactly as before the loop moved (lam and mu rtol 1e-5,
n_inner and masks equal), for the four variants (gamma grid, outage
priced, joint (gamma, bits), both), capped and stopped early, with dead
clients (the 40-level joint grid, the paper's 10 gammas x 4 widths, in
``test_torch_solver_ascent_grid40.py``; the rounds themselves in
``tests/torch_solver_rounds.py``). ``chip_smoke.py`` holds the CUDA
kernel against the same plain version on the card.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import FairEnergyConfig as TFE
from repro_torch.core.fairenergy import init_state, static_of
from repro_torch.kernels.dual_solve import ops, ref
from torch_solver_rounds import (B_TOT, BITS, BITS40, I_BITS, N0, S_BITS, VARIANTS,
                                 ascent_kwargs, draws, hold_rounds)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("case", ["capped", "early_exit", "dead_clients"])
def test_dual_ascent_ref_matches_reference_solver(variant, case):
    """Four warm-started rounds: ``dual_ascent_ref`` from each round's state
    gives the reference's lam, mu and n_inner, and ``solve_round`` (which
    calls the wrapper, hence the plain version on the CPU) its masks,
    gammas and widths."""
    hold_rounds(variant, case, BITS)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_wrapper_runs_the_plain_version_on_cpu_and_counts_no_launch(variant):
    priced, joint = VARIANTS[variant]
    n = 10
    u, h, P, es = (torch.tensor(a) for a in draws(n, 5))
    tfe = TFE(eta_auto=False, eta=1e-3, bits_grid=BITS if joint else (32.0,))
    st = init_state(tfe, n, b_tot=B_TOT, s_bits=S_BITS, i_bits=I_BITS, n0=N0,
                    device="cpu")
    alive = torch.ones(n, dtype=torch.bool)
    args = (P, h, u, st.lam, st.mu, st.q, alive)
    kw = dict(ascent_kwargs(st, static_of(tfe)), e_scale=es if priced else None)
    before = {a: getattr(ops.dual_ascent, a) for a in ops.COUNTERS.values()}
    got = ops.dual_ascent(*args, **kw)
    want = ref.dual_ascent_ref(*args, **kw)
    assert {a: getattr(ops.dual_ascent, a) for a in ops.COUNTERS.values()} == before
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)
    assert got.n_inner.dtype == torch.int32 and got.n_inner.ndim == 0
    assert (got.bits is not None) == joint


def test_ascent_packing_equals_the_plain_versions_constants():
    """The fused kernel's level table holds the best response's per-level
    constants and, on the joint grid, the float32 fidelity that the plain
    version's selection test multiplies in; its scalar vector holds the
    solver scalars in the kernel's order, as float32."""
    grid = (0.1, 0.25, 0.5, 1.0)
    for bits_grid in (None, BITS, (2.0, 4.0, 8.0, 16.0, 32.0)):
        table = ops.ascent_levels(grid, bits_grid)
        coef = ref.level_coefficients(grid, bits_grid)
        L = len(coef["gamma"])
        assert len(table) == 5 * L
        blocks = [table[i * L:(i + 1) * L] for i in range(5)]
        assert blocks[0] == coef["gamma"]
        assert blocks[1] == coef["pay"] and blocks[2] == coef["score"]
        if bits_grid is None:
            assert blocks[3] == [0.0] * L and blocks[4] == [1.0] * L
            continue
        assert blocks[3] == coef["bits"]
        # the fidelity the plain version computes from a decided width
        decided = torch.tensor(coef["bits"], dtype=torch.float32)
        want = ref.score_fidelity(decided)
        got = torch.tensor(blocks[4], dtype=torch.float32)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # past the 32 levels of one lane group: 11 x 3 = 33, 40, 100 levels,
    # packed alike, and the cached device buffer holds the same floats
    for grid, bits_grid in ((tuple(range(1, 12)), BITS),
                            ((0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0), BITS40),
                            (tuple((i + 1) / 100 for i in range(100)), None)):
        table = ops.ascent_levels(grid, bits_grid)
        coef = ref.level_coefficients(grid, bits_grid)
        L = len(coef["gamma"])
        assert L in (33, 40, 100) and len(table) == 5 * L
        assert table[:3 * L] == coef["gamma"] + coef["pay"] + coef["score"]
        if bits_grid is not None:
            assert table[3 * L:4 * L] == coef["bits"]
        buf = ops.level_table(grid, bits_grid, torch.device("cpu"))
        assert buf.dtype == torch.float32 and buf.shape == (5 * L,)
        assert torch.equal(buf, torch.tensor(table, dtype=torch.float32))
        assert ops.level_table(list(grid), bits_grid, torch.device("cpu")) is buf

    tfe = TFE(eta_auto=False, eta=1e-3, dual_tol=0.25)
    st = init_state(tfe, 4, b_tot=B_TOT, s_bits=S_BITS, i_bits=I_BITS, n0=N0,
                    device="cpu")
    p = st.params
    lam = torch.tensor(3e-4)
    sc = ops.ascent_scalars(lam=lam, eta=p.eta, b_tot=p.b_tot, s_bits=p.s_bits,
                            i_bits=p.i_bits, n0=p.n0, b_lo=p.b_min_frac,
                            rho=p.rho, pi_min=p.pi_min,
                            alpha_lambda=p.alpha_lambda, alpha_mu=p.alpha_mu,
                            dual_tol=p.dual_tol, device=torch.device("cpu"))
    want = torch.stack([lam, p.eta, p.b_tot, p.s_bits, p.i_bits, p.n0,
                        p.b_min_frac, p.rho, p.pi_min, p.alpha_lambda,
                        p.alpha_mu, p.dual_tol])
    assert sc.dtype == torch.float32 and torch.equal(sc, want)


# ---- the fused kernel's argmin over a client's levels -----------------------
def _scan_argmin(phi):
    """The one-step kernel's running strict-< minimum over the levels."""
    best = 0
    for i in range(1, len(phi)):
        if phi[i] < phi[best]:
            best = i
    return best


def _butterfly_argmin(phi, lanes):
    """A model of ``best_level`` in ``csrc/dual_solve.cu``: lane l holds
    levels l, l + lanes, ... (idle beyond the grid) and first reduces them
    in increasing order, a later level replacing its best only by a lower
    class or, both numbers, a strictly smaller phi; then log2(lanes)
    xor-shuffle rounds, each lane keeping the better of itself and its
    partner under the order (level 0 with a NaN phi) < (numbers by value,
    then level) < (NaN phis and idle lanes, by level). Returns every
    lane's result."""
    def key(level):
        v = phi[level]
        if v != v:
            return (0 if level == 0 else 2, 0.0, level)
        return (1, v, level)

    def lane_best(lane):           # the lane-strided pass
        if lane >= len(phi):
            return (2, 0.0, lane)
        best = key(lane)
        for level in range(lane + lanes, len(phi), lanes):
            k = key(level)
            if k[0] < best[0] or (k[0] == best[0] == 1 and k[1] < best[1]):
                best = k
        return best

    def better(a, b):              # the kernel's `take` test, b over a
        if b[0] != a[0]:
            return b[0] < a[0]
        if b[0] == 1:
            return b[1] < a[1] or (b[1] == a[1] and b[2] < a[2])
        return b[2] < a[2]

    state = [lane_best(i) for i in range(lanes)]
    o = lanes // 2
    while o:
        state = [state[i ^ o] if better(state[i], state[i ^ o]) else state[i]
                 for i in range(lanes)]
        o //= 2
    return [s[2] for s in state]


def test_shuffle_argmin_combine_rule_matches_the_running_minimum():
    """Ties, +-inf, -0.0 against +0.0 and NaN anywhere (level 0 included),
    on grids of 1 to 200 levels (above 32 a lane holds several): the
    lane-strided pass and the butterfly pick the running minimum's level,
    and every lane of the group agrees on it."""
    rng = np.random.default_rng(0)
    nan, inf = float("nan"), float("inf")
    rows = [[1.0, 1.0, 0.5, 0.5], [nan, 0.1, -1.0], [0.3, nan, 0.2, nan],
            [nan, nan, nan], [inf, inf, 2.0, inf], [inf, inf, inf],
            [-0.0, 0.0, -0.0], [0.0, -0.0], [2.0], [nan],
            [-inf, -inf, nan, -inf], [5.0, nan, 5.0, 4.0, 4.0]]
    # a NaN at a lane's first level beside numbers at its later ones, which
    # a running strict-< pass alone would hide
    rows += [[0.5] + [nan] * 31 + [0.1], [0.5, nan] + [1.0] * 31 + [-2.0],
             [nan] * 40 + [-1.0], [1.0] * 64 + [-0.0, 0.0, -0.0]]
    for _ in range(400):
        L = int(rng.integers(1, 201)) if _ % 2 else int(rng.integers(1, 33))
        row = np.round(rng.normal(size=L), 1).tolist()   # many ties
        for i in np.flatnonzero(rng.random(L) < 0.15):
            row[i] = [nan, inf, -inf, -0.0][int(rng.integers(0, 4))]
        rows.append(row)
    for row in rows:
        phi = [float(np.float32(v)) for v in row]
        want = _scan_argmin(phi)
        # the kernel's groups: 16 lanes up to 16 levels, 32 above
        for lanes in ((16, 32) if len(phi) <= 16 else (32,)):
            got = _butterfly_argmin(phi, lanes)
            assert got == [want] * lanes, (row, lanes, got, want)
