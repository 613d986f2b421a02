"""The port's quantized-payload primitives (``repro_torch.fl.compression``,
``core.channel.payload_bits`` and the joint-grid helpers of
``kernels.dual_solve.ref``) against the JAX package's.

``quantize_rows`` is plain arithmetic in both packages (round half to
even, XLA's exp2 for qmax), so its output must be bit-equal on every
lane, signed zeros and screened NaN/Inf lanes included. The payload
accounting, the realized keep fraction, the fidelity factor and the level
ordering must be exactly equal too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import compression as jc
from repro.kernels.dual_solve import ref as j_ref

from repro_torch.core import channel as tch
from repro_torch.fl import compression as tc
from repro_torch.kernels.dual_solve import ref as t_ref
from repro_torch.xla_math import exp2_xla


def _bits_equal(got: torch.Tensor, want) -> None:
    w = np.asarray(want)
    assert got.dtype == torch.float32 and w.dtype == np.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32), w.view(np.int32))


def _rows(n=10, d=333, seed=0):
    rng = np.random.default_rng(seed)
    rows = (rng.normal(size=(n, d)) * 3e-3).astype(np.float32)
    rows[1, ::7] = np.nan
    rows[2, ::5] = np.inf
    rows[2, 1::5] = -np.inf
    rows[3, ::2] = -0.0
    rows[4] = 0.0                              # all-zero row: scale floor
    rows[5] = -0.0
    rows[6] = np.round(rows[6] * 1e3) / 1e3    # ties at half a step
    rows[7, :] = np.nan                        # nothing finite at all
    rows[8] = rows[8] * 1e30                   # large magnitudes
    rows[9, 0] = 1.0                           # one spike over tiny values
    return rows


@pytest.mark.parametrize("bits", [2.0, 8.0, 16.0, 32.0])
def test_quantize_rows_bit_equal(bits):
    rows = _rows()
    b = np.full(rows.shape[0], bits, np.float32)
    got = tc.quantize_rows(torch.tensor(rows), torch.tensor(b))
    _bits_equal(got, jc.quantize_rows(jnp.asarray(rows), jnp.asarray(b)))
    assert torch.isfinite(got).all()


def test_quantize_rows_mixed_widths_per_row():
    rows = _rows(n=12, d=4096 + 17, seed=1)
    b = np.array([2, 8, 16, 32, 8, 16, 32, 2, 12, 24, 31, 33], np.float32)
    _bits_equal(tc.quantize_rows(torch.tensor(rows), torch.tensor(b)),
                jc.quantize_rows(jnp.asarray(rows), jnp.asarray(b)))


def test_quantize_rows_keeps_zeros_and_passes_32_bits_through():
    rows = _rows()
    got = tc.quantize_rows(torch.tensor(rows),
                           torch.full((rows.shape[0],), 32.0)).numpy()
    finite = np.isfinite(rows)
    np.testing.assert_array_equal(got[finite].view(np.int32),
                                  rows[finite].view(np.int32))
    assert (got[~finite] == 0.0).all()
    q8 = tc.quantize_rows(torch.tensor(rows), torch.full((10,), 8.0)).numpy()
    assert (q8[rows == 0.0] == 0.0).all()


@pytest.mark.parametrize("value_bits", [8, 16, 32])
@pytest.mark.parametrize("bitmap_index", [True, False])
def test_payload_bits_equals_reference(value_bits, bitmap_index):
    for n_params in (504, 1_630_090):
        for g in (0.1, 0.25, 0.3, 1.0):
            # the reference's fl-level shim, against the port's one
            # payload formula at the same float32 arguments
            got = float(tch.payload_bits(
                torch.tensor(g, dtype=torch.float32), 32.0 * n_params,
                float(n_params) if bitmap_index else 0.0,
                value_bits=float(value_bits)))
            assert got == jc.payload_bits(n_params, g, value_bits=value_bits,
                                          bitmap_index=bitmap_index)


def test_effective_gamma_equals_reference():
    g = np.array([1e-9, 0.1, 0.2, 0.25, 0.3, 0.7, 0.9999, 1.0, 1.5],
                 np.float32)
    _bits_equal(tc.effective_gamma(torch.tensor(g)),
                jc.effective_gamma(jnp.asarray(g)))


def test_xla_exp2_fidelity_and_levels():
    x = np.arange(-40, 32, dtype=np.float32)
    _bits_equal(exp2_xla(torch.tensor(x)), jnp.exp2(jnp.asarray(x)))
    widths = np.array([2, 4, 8, 12, 16, 24, 32], np.float32)
    _bits_equal(t_ref.score_fidelity(torch.tensor(widths)),
                j_ref.score_fidelity(jnp.asarray(widths)))
    assert float(t_ref.score_fidelity(32.0)) == 1.0
    for gg, bg in [((0.1, 0.5), (8.0, 32.0)),
                   ((0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0),
                    (8.0, 16.0, 32.0))]:
        assert t_ref.joint_levels(gg, bg) == j_ref.joint_levels(gg, bg)
    coef = t_ref.level_coefficients((0.1, 0.3), (8.0, 32.0))
    assert coef["pay"] == [0.1 * 8 / 32, 0.1, 0.3 * 8 / 32, 0.3]
    assert coef["score"][1] == 0.1 * (1.0 - 2.0 ** -31)
