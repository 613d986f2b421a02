"""Wireless uplink model (paper Sec. II-B), in PyTorch.

Rate follows Shannon capacity R = B log2(1 + P h / (N0 B)); payload is
``gamma * S + I`` bits; T = payload / R; E = P * T. Channel gains combine
a distance^-alpha pathloss with per-round Rayleigh fading. Every function
works elementwise on float32 tensors (Python floats broadcast as float32)
and keeps the JAX package's operation order, so the two agree to the last
few ulps.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import random as prng

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


def round_fading(key: Tensor, round_idx: int, n: int) -> Tensor:
    """Rayleigh fading powers for round ``round_idx``: an exponential draw
    under ``fold_in(key, round)``, pure in (key, round)."""
    return prng.exponential(prng.fold_in(key, round_idx), (n,))


def round_gains(key: Tensor, pathloss: Tensor, round_idx: int,
                rayleigh: bool = True) -> Tensor:
    """h_i^r = pathloss_i x fade_i^r (fade == 1 when Rayleigh is off).
    Mobility drift is not ported yet (ROADMAP A-15)."""
    if not rayleigh:
        return pathloss
    fade = round_fading(key, round_idx, pathloss.shape[0])
    return pathloss * fade.to(pathloss.device)


class WirelessNetwork:
    """Static client geometry + per-round fading.

    The geometry comes from the same numpy generator calls as the JAX
    package's, so ``power`` and ``pathloss`` are equal to the bit; fading
    is pure in (seed, round) through ``repro_torch.random``.

    ``device_profile`` (a ``core.energy.DeviceProfile``, or a kind string
    such as "tiered" built by ``make_profile``) rides along without
    touching the channel draws: power and distance are drawn first. An
    enabled ``mobility`` config is not ported yet (ROADMAP A-15)."""

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
        if mobility is not None and getattr(mobility, "sigma_db", 0.0) > 0.0:
            raise NotImplementedError(
                "mobility (pathloss drift) is not ported yet: ROADMAP A-15")
        self.mobility = None
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
                           self.cfg.rayleigh).numpy()
