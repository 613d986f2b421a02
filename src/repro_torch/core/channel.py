"""Wireless uplink model (paper Sec. II-B), in PyTorch.

Rate follows Shannon capacity R = B log2(1 + P h / (N0 B)); payload is
``gamma * S + I`` bits; T = payload / R; E = P * T. Channel gains combine
a distance^-alpha pathloss with per-round Rayleigh fading and, with a
``MobilityConfig``, a slow pathloss drift. Every function works
elementwise on float32 tensors (Python floats broadcast as float32) and
keeps the JAX package's operation order, so the two agree to the last few
ulps; the fading and the drift are drawn on the host and are bit-equal to
the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import random as prng
from ..xla_math import fma_f32, log1p_xla, pow_xla, sin_xla
from .streams import MOBILITY_STREAM

Tensor = torch.Tensor

# thermal noise density kT at 290K ~ 4e-21 W/Hz (-174 dBm/Hz)
THERMAL_N0 = 4e-21
REF_GAIN_1M = 1e-3  # -30 dB at 1 m

# Bandwidths are clamped to this floor before the rate computation: the
# B -> 0 limit of the rate has unbounded SNR, which overflows fp32.
# Callers never allocate below 1 Hz (ControllerContext checks the bracket).
RATE_B_FLOOR_HZ = 1.0

# guard on the rate divisor in comm_time (and every energy model built on
# it, incl. kernels.dual_solve): rates below this count as this
RATE_EPS = 1e-9

LN2 = 0.6931471805599453


def shannon_rate(B, P, h, n0=THERMAL_N0) -> Tensor:
    """bits/s: R = B log2(1 + P h / (N0 B)) with B clamped to
    ``RATE_B_FLOOR_HZ``; log2(1+x) is log1p(x)/ln2, which keeps low-SNR
    rates precise in fp32."""
    B = torch.clamp(torch.as_tensor(B), min=RATE_B_FLOOR_HZ)
    snr = P * h / (n0 * B)
    return B * torch.log1p(snr) / LN2


def snr_coeff(P, h, n0=THERMAL_N0) -> Tensor:
    """c = P h / N0 (Hz): the SNR at bandwidth B is c / B."""
    return P * h / n0


def bandwidth_from_snr(c, t):
    """The bandwidth (Hz) at which the SNR is ``t``, given the SNR
    coefficient ``c = P h / N0``: B = c / t, the inverse of ``snr_coeff``'s
    rate variable."""
    return c / t


def payload_bits(gamma, s_bits, i_bits, value_bits=None):
    """``gamma*S*(value_bits/32) + I``: the full-precision value payload
    scaled by the keep ratio and the width (``None``: 32 bits), plus the
    index/mask overhead, which quantization cannot shrink."""
    if value_bits is None:
        return gamma * s_bits + i_bits
    return gamma * (torch.as_tensor(value_bits) / 32.0) * s_bits + i_bits


def comm_time(gamma, B, P, h, s_bits, i_bits, n0=THERMAL_N0) -> Tensor:
    """Seconds to push the payload; ``inf`` below the bandwidth floor (a
    sub-floor allocation cannot transmit)."""
    rate = shannon_rate(B, P, h, n0)
    t = payload_bits(gamma, s_bits, i_bits) / torch.clamp(rate, min=RATE_EPS)
    B = torch.as_tensor(B, device=t.device)
    return torch.where(B >= RATE_B_FLOOR_HZ, t, np.inf)


def comm_energy(gamma, B, P, h, s_bits, i_bits, n0=THERMAL_N0) -> Tensor:
    """Joules (paper: E_i = P_i T_i)."""
    return P * comm_time(gamma, B, P, h, s_bits, i_bits, n0)


def comm_energy_eager(gamma: float, B: float, P: Tensor, h: Tensor,
                      s_bits: float, i_bits: float, n0=THERMAL_N0) -> Tensor:
    """``comm_energy`` of float32 CPU tensors at a scalar gamma and B, as
    the JAX package computes it op by op outside ``jit`` (its eta_auto
    calibration does): XLA's ``log1p``, and the payload, a Python float,
    rounded to float32 and divided by the rate in one true division
    (``float / tensor`` in PyTorch multiplies by the reciprocal, which
    rounds twice; ROADMAP C-20)."""
    B = torch.clamp(torch.as_tensor(B, dtype=torch.float32), min=RATE_B_FLOOR_HZ)
    snr = P * h / (n0 * B)
    rate = B * log1p_xla(snr) / LN2
    payload = torch.as_tensor(payload_bits(gamma, s_bits, i_bits),
                              dtype=torch.float32)
    t = torch.div(payload, torch.clamp(rate, min=RATE_EPS))
    return P * torch.where(B >= RATE_B_FLOOR_HZ, t, np.inf)


def round_fading(key: Tensor, round_idx: int, n: int) -> Tensor:
    """Rayleigh fading powers for round ``round_idx``: an exponential draw
    under ``fold_in(key, round)``, pure in (key, round)."""
    return prng.exponential(prng.fold_in(key, round_idx), (n,))


# incommensurate harmonic mixture for the slow drift waveform, with a
# closed-form RMS so sigma_db is an exact shadowing scale
_MOB_FREQS = (1.0, 0.521, 0.287)
_MOB_AMPS = (1.0, 0.6, 0.35)
_TWO_PI = 6.283185307179586


@dataclasses.dataclass(frozen=True)
class MobilityConfig:
    """Slow log-normal pathloss drift from client mobility: each client's
    pathloss is multiplied by ``10 ** (sigma_db * w_i(r) / 10)``, where
    ``w_i(r)`` is a unit-RMS mixture of incommensurate sinusoids with
    per-client random phases — a closed-form function of the round, so
    the drift is (seed, round)-pure. ``sigma_db`` is the RMS shadowing
    scale in dB; ``sigma_db = 0`` is the static channel."""
    sigma_db: float = 3.0        # RMS drift amplitude (dB)
    period_rounds: float = 40.0  # rounds per slowest-harmonic cycle

    def __post_init__(self):
        if self.sigma_db < 0.0:
            raise ValueError(f"sigma_db must be >= 0, got {self.sigma_db}")
        if self.period_rounds <= 0.0:
            raise ValueError(f"period_rounds must be > 0, "
                             f"got {self.period_rounds}")

    @property
    def enabled(self) -> bool:
        return self.sigma_db > 0.0


def _drift_constants(mobility: MobilityConfig):
    """The float32 constants of the drift as the JAX package's scanned
    round folds them: the harmonics' ``f_j / period`` (each rounded; the
    round's ``r * f32(2 pi)`` multiplies them), and ``sigma_db / 10 / rms``
    as ``(sigma_db * f32(0.1)) * (1 / rms)``, where ``rms = sqrt(sum(amps^2)
    / 2)`` is summed in order."""
    f32 = np.float32
    period = f32(mobility.period_rounds)
    freqs = [f32(f32(f) / period) for f in _MOB_FREQS]
    ssq = f32(0.0)
    for a in _MOB_AMPS:
        ssq = f32(ssq + f32(f32(a) * f32(a)))
    rms = np.sqrt(f32(ssq / f32(2.0)), dtype=f32)
    scale = f32(f32(f32(mobility.sigma_db) * f32(0.1)) * f32(f32(1.0) / rms))
    return [float(f) for f in freqs], float(scale)


def mobility_drift(key: Tensor, round_idx: int, n: int,
                   mobility: MobilityConfig) -> Tensor:
    """[N] multiplicative pathloss drift for round ``round_idx`` (float32,
    on the host), pure in (key, round) and bit-equal to the drift of the
    JAX package's scanned round. The per-client phases come from
    ``uniform(fold_in(key, MOBILITY_STREAM), (n, 3), 0, 2 pi)``, never the
    round's fading draw. Harmonic j's argument is ``f32(f32(r * f32(2 pi))
    * (f_j / period)) + phase`` (the association XLA gives the scanned
    round), its sine is XLA's (``sinf``), the three terms are summed by
    FMAs in order, scaled by the folded constant and raised as ``powf(10,
    .)``."""
    phases = prng.uniform(prng.fold_in(key, MOBILITY_STREAM),
                          (n, len(_MOB_FREQS)), 0.0, _TWO_PI)
    freqs, scale = _drift_constants(mobility)
    f32 = np.float32
    r2pi = f32(f32(round_idx) * f32(_TWO_PI))
    w = torch.zeros(n, dtype=torch.float32)
    for j, (f, a) in enumerate(zip(freqs, _MOB_AMPS)):
        arg = float(f32(r2pi * f32(f))) + phases[:, j]
        w = fma_f32(float(f32(a)), sin_xla(arg), w)
    return pow_xla(10.0, w * scale)


def round_gains(key: Tensor, pathloss: Tensor, round_idx: int,
                rayleigh: bool = True,
                mobility: Optional[MobilityConfig] = None) -> Tensor:
    """h_i^r = pathloss_i x drift_i^r x fade_i^r (fade == 1 when Rayleigh
    is off; drift == 1 without an enabled mobility config)."""
    if mobility is not None and mobility.enabled:
        drift = mobility_drift(key, round_idx, pathloss.shape[0], mobility)
        pathloss = pathloss * drift.to(pathloss.device)
    if not rayleigh:
        return pathloss
    fade = round_fading(key, round_idx, pathloss.shape[0])
    return pathloss * fade.to(pathloss.device)


def eager_mobility_drift(key: Tensor, round_idx: int, n: int,
                         mobility: MobilityConfig) -> Tensor:
    """``mobility_drift`` as the JAX package computes it op by op outside
    ``jit`` (its ``WirelessNetwork.gains``): the harmonics' argument is
    ``f32(f32(2 pi) * f_j) * r + phase``, each product rounded, the three
    terms added one after another from 0, divided by the RMS, then by
    ``sigma_db`` and 10 in two roundings; no FMA. It differs from the
    scanned round's drift in the last ulps (ROADMAP C-20)."""
    f32 = np.float32
    phases = prng.uniform(prng.fold_in(key, MOBILITY_STREAM),
                          (n, len(_MOB_FREQS)), 0.0, _TWO_PI)
    period, r = f32(mobility.period_rounds), f32(round_idx)
    w = torch.zeros(n, dtype=torch.float32)
    ssq = f32(0.0)
    for j, (f, a) in enumerate(zip(_MOB_FREQS, _MOB_AMPS)):
        arg = float(f32(f32(f32(_TWO_PI) * f32(f32(f) / period)) * r))
        w = w + float(f32(a)) * sin_xla(arg + phases[:, j])
        ssq = f32(ssq + f32(f32(a) * f32(a)))
    rms = np.sqrt(f32(ssq / f32(2.0)), dtype=f32)
    w = torch.div(w, torch.tensor(float(rms)))
    x = torch.div(float(f32(mobility.sigma_db)) * w, torch.tensor(10.0))
    return pow_xla(10.0, x)


class WirelessNetwork:
    """Static client geometry + per-round fading.

    The geometry comes from the same numpy generator calls as the JAX
    package's, so ``power`` and ``pathloss`` are equal to the bit; fading
    is pure in (seed, round) through ``repro_torch.random``.

    ``device_profile`` (a ``core.energy.DeviceProfile``, or a kind string
    such as "tiered" built by ``make_profile``) rides along without
    touching the channel draws: power and distance are drawn first.
    ``mobility`` (a ``MobilityConfig``) adds the slow pathloss drift; a
    disabled one (``sigma_db = 0``) is normalized to ``None``, the static
    channel."""

    def __init__(self, cfg, seed: int = 0, device_profile=None,
                 mobility=None):
        rng = np.random.default_rng(seed)
        self.cfg = cfg
        n = cfg.n_clients
        self.power = rng.uniform(cfg.power_min, cfg.power_max, n)          # P_i
        self.distance = rng.uniform(50.0, cfg.cell_radius_m, n)            # d_i
        self.pathloss = REF_GAIN_1M * self.distance ** (-cfg.pathloss_exp)
        self.fade_key = prng.PRNGKey(seed)
        self._pathloss_t = torch.as_tensor(self.pathloss, dtype=torch.float32)
        if mobility is not None and not mobility.enabled:
            mobility = None
        self.mobility = mobility
        if isinstance(device_profile, str):
            from .energy import make_profile
            device_profile = make_profile(device_profile, n, seed=seed)
        if device_profile is not None and device_profile.n_clients != n:
            raise ValueError(f"device profile has {device_profile.n_clients} "
                             f"clients, network has {n}")
        self.device_profile = device_profile

    def gains(self, round_idx: int = 0) -> np.ndarray:
        """h_i^r as a float32 numpy array, pure in (seed, round_idx)."""
        return round_gains(self.fade_key, self._pathloss_t, round_idx,
                           self.cfg.rayleigh, mobility=self.mobility).numpy()

    def calibration_gains(self, round_idx: int = 0) -> np.ndarray:
        """h_i^r as the JAX package's eager ``gains(r)`` computes them, the
        drift by ``eager_mobility_drift``: what eta_auto calibrates on.
        Without mobility it is ``gains(r)``."""
        if self.mobility is None:
            return self.gains(round_idx)
        n = self._pathloss_t.shape[0]
        h = self._pathloss_t * eager_mobility_drift(self.fade_key, round_idx,
                                                    n, self.mobility)
        if self.cfg.rayleigh:
            h = h * round_fading(self.fade_key, round_idx, n)
        return h.numpy()
