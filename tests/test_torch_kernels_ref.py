"""The port's kernel wrappers on CPU tensors (their plain PyTorch versions)
against the JAX package's kernels (Pallas in interpret mode) and refs.

The CUDA/Triton kernels themselves are compared with these plain versions
on the card by ``chip_smoke.py``; these tests need no GPU.

Tolerances: dual-solve gamma* exactly equal (no near-tie occurs on these
draws), b*/e*/phi* rtol 1e-5 with atol 1e-8 for phi* crossing zero;
top-k masks and outputs bit-identical on every lane (a dropped lane is
+0.0, whatever it held); row norms rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl.compression import batch_block_topk as j_batch_block_topk
from repro.kernels.dual_solve import ops as j_ds_ops
from repro.kernels.dual_solve import ref as j_ds_ref
from repro.kernels.score_norm.ops import l2_norm as j_l2_norm
from repro.kernels.topk_sparsify.kernel import topk_sparsify_rows_pallas
from repro.kernels.topk_sparsify.ref import topk_threshold_mask as j_mask

from repro_torch.fl.compression import batch_block_topk
from repro_torch.kernels.dual_solve.ops import dual_solve
from repro_torch.kernels.score_norm.ops import row_l2_norms
from repro_torch.kernels.topk_sparsify.ref import (block_topk_rows,
                                                   block_topk_rows_ref,
                                                   topk_threshold_mask)

GRID = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)
N0, S_BITS, I_BITS = 4e-21, 6.4e7, 2e6


# --------------------------------------------------------- dual solve ----
def _ds_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    P = rng.uniform(1e-4, 3e-4, n).astype(np.float32)
    h = (1e-3 * rng.uniform(50, 500, n) ** -3.0
         * rng.exponential(1.0, n)).astype(np.float32)
    u = rng.uniform(0.1, 5.0, n).astype(np.float32)
    e_cmp = np.zeros(n, np.float32)
    return P, h, u, e_cmp


def _scalars(lam, lib):
    f = (lambda v: jnp.float32(v)) if lib == "jax" else \
        (lambda v: torch.tensor(v, dtype=torch.float32))
    return f(lam), dict(eta=f(1e-3), b_tot=f(1e7), s_bits=f(S_BITS),
                        i_bits=f(I_BITS), n0=f(N0), b_lo=f(1e-4))


@pytest.mark.parametrize("n", [8, 200, 513])
@pytest.mark.parametrize("lam", [0.0, 1e-4, 3e-3, 0.2])
def test_dual_solve_plain_matches_pallas_and_ref(n, lam):
    P, h, u, ec = _ds_inputs(n)
    jl, jkw = _scalars(lam, "jax")
    tl, tkw = _scalars(lam, "torch")
    jargs = tuple(map(jnp.asarray, (P, h, u)))
    want_pallas = j_ds_ops.dual_solve(*jargs, jl, gamma_grid=GRID, **jkw,
                                      e_cmp=jnp.asarray(ec))
    want_ref = j_ds_ref.dual_solve_ref(*jargs, jl, gamma_grid=GRID, **jkw,
                                       e_cmp=jnp.asarray(ec))
    got = dual_solve(*map(torch.tensor, (P, h, u)), tl, gamma_grid=GRID,
                     **tkw, e_cmp=torch.tensor(ec))
    for want in (want_pallas, want_ref):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]),
                                      err_msg="gamma*")
        for g, w, name in zip(got[1:], want[1:], ("b*", "e*", "phi*")):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-8, err_msg=name)


def test_dual_solve_counts_no_launch_on_cpu():
    before = dual_solve.launches
    P, h, u, _ = _ds_inputs(8)
    tl, tkw = _scalars(1e-3, "torch")
    dual_solve(*map(torch.tensor, (P, h, u)), tl, gamma_grid=GRID, **tkw)
    assert dual_solve.launches == before


# --------------------------------------------------------------- top-k ----
def _tricky_rows(block=4096, seed=0):
    """Rows with ties, NaN, +-Inf, -0.0 and a quantized (tie-heavy) row."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(8, block)).astype(np.float32)
    rows[1, ::7] = np.nan
    rows[2, ::5] = np.inf
    rows[2, 1::5] = -np.inf
    rows[3] = np.round(rows[3] * 2) / 2                     # many ties
    rows[4, :] = -0.0
    rows[4, ::3] = 1.0
    rows[5, :] = 0.5                                        # all tied
    rows[6, :100] = np.nan                                  # >= k NaNs
    rows[7, ::2] = -0.0
    return rows


@pytest.mark.parametrize("ks", [[1, 1, 1, 1, 1, 1, 1, 1],
                                [409, 410, 2048, 4095, 17, 3000, 50, 4096],
                                [4096] * 8])
def test_topk_mask_matches_reference_mask(ks):
    rows = _tricky_rows()
    k = np.asarray(ks, np.int32)[:, None]
    want = np.asarray(j_mask(jnp.asarray(rows), jnp.asarray(k)))
    got = topk_threshold_mask(torch.tensor(rows), torch.tensor(k)).numpy()
    np.testing.assert_array_equal(got, want)


def _assert_same_bits(got, want):
    """Bit-identical float32 arrays, NaN payloads and signed zeros included."""
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("ks", [[1, 2, 3, 4, 5, 6, 7, 8],
                                [409, 410, 2048, 4095, 17, 3000, 50, 4096],
                                [4096, 4096, 4096, 2, 4096, 1, 4096, 4096]])
def test_topk_rows_match_pallas_kernel_and_sort_oracle(ks):
    """Rows with k = 4096 beside sparsified ones take the mask at k = 4096,
    as the reference's kernel does: every lane but a NaN is kept."""
    rows = _tricky_rows()
    k = np.asarray(ks, np.int32)
    want = np.asarray(topk_sparsify_rows_pallas(jnp.asarray(rows),
                                                jnp.asarray(k)))
    got = block_topk_rows(torch.tensor(rows), torch.tensor(k)).numpy()
    _assert_same_bits(got, want)
    finite = np.isfinite(rows).all(axis=1)
    oracle = block_topk_rows_ref(torch.tensor(rows[finite]),
                                 torch.tensor(k[finite])).numpy()
    _assert_same_bits(got[finite], oracle)


def _update_matrix(d):
    rng = np.random.default_rng(d)
    mat = rng.normal(size=(3, d)).astype(np.float32)
    mat[0, ::11] = 0.25                                     # ties
    mat[1, 5] = -0.0
    mat[1, 7::13] = -mat[1, 7::13] ** 2                     # negatives dropped
    mat[2, 3::17] = np.nan
    mat[2, 4::19] = np.inf
    mat[0, 9::23] = -np.inf
    return mat


@pytest.mark.parametrize("d", [4096, 52_138, 10_000])
@pytest.mark.parametrize("gammas", [[0.1, 0.5, 1.0], [1.0, 1.0, 1.0],
                                    [1e-6, 0.3, 0.999], [0.2, 1.0, 1.0]])
def test_batch_block_topk_matches_reference(d, gammas):
    """Through the reference's batch_block_topk: its all-full skip copies
    NaN and Inf through; any other batch drops NaN even at gamma = 1."""
    mat = _update_matrix(d)
    g = np.asarray(gammas, np.float32)
    want = np.asarray(j_batch_block_topk(jnp.asarray(mat), jnp.asarray(g)))
    got = batch_block_topk(torch.tensor(mat), torch.tensor(g)).numpy()
    _assert_same_bits(got, want)


# ----------------------------------------------------------- row norms ----
@pytest.mark.parametrize("d", [1, 100, 8192, 52_138, 70_000])
def test_row_norms_match_reference_l2_norm(d):
    rng = np.random.default_rng(d)
    mat = (rng.normal(size=(4, d)) * 10.0 ** rng.uniform(-3, 3, (4, 1))
           ).astype(np.float32)
    got = row_l2_norms(torch.tensor(mat)).numpy()
    want = np.asarray([float(j_l2_norm(jnp.asarray(r))) for r in mat])
    np.testing.assert_allclose(got, want, rtol=1e-6)
