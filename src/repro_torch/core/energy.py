"""Heterogeneous device-energy model: local computation + batteries.

The port's copy of ``repro.core.energy``. A device running C
cycles/sample at CPU frequency f with effective switched capacitance
kappa spends, per round of ``n_samples``,

    T_cmp = C * n_samples / f            (seconds)
    E_cmp = kappa * C * n_samples * f^2  (Joules)

E_cmp does not depend on the compression ratio or the bandwidth, so it
enters the per-device subproblem as an additive constant (the solver's
``ControllerState.e_cmp``). ``DeviceProfile`` holds the [N] float32
per-client parameters on the host (CPU tensors); the trainer moves what
it needs to its device.

The constructors draw from their own ``np.random.default_rng`` streams,
the same calls as the reference's, so every profile array is equal to
the JAX package's bit for bit and never shifts the network's draws.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

# profile randomness stream offsets (the reference's values)
_TIER_STREAM = 7001
_BATTERY_STREAM = 7002

#: unlimited battery sentinel — inf survives any finite drain, so the
#: alive mask (charge > 0) stays all-true
UNLIMITED_J = float("inf")

DEFAULT_FREQ_HZ = 1.0e9
DEFAULT_KAPPA = 1.0e-28
DEFAULT_CYCLES = 1.0e5

#: (name, f Hz, kappa, cycles/sample) — low/mid/high CPU tiers
DEFAULT_TIERS: Tuple[Tuple[str, float, float, float], ...] = (
    ("low", 0.5e9, DEFAULT_KAPPA, DEFAULT_CYCLES),
    ("mid", 1.0e9, DEFAULT_KAPPA, DEFAULT_CYCLES),
    ("high", 2.0e9, DEFAULT_KAPPA, DEFAULT_CYCLES),
)

#: per-tier default uplink quantization width (bits/coefficient), aligned
#: with DEFAULT_TIERS
DEFAULT_TIER_BITS: Tuple[float, ...] = (8.0, 16.0, 32.0)


def _f32(values) -> Tensor:
    return torch.tensor(np.asarray(values, np.float32))


class DeviceProfile(NamedTuple):
    """Per-client device parameters ([N] float32 each). ``bits`` is the
    per-client default uplink width; ``None`` means full 32-bit payloads
    and keeps the trainer's quantized path off."""
    freq: Tensor      # CPU frequency f_i (cycles/s)
    kappa: Tensor     # effective switched capacitance kappa_i
    cycles: Tensor    # CPU cycles per training sample C_i
    battery: Tensor   # battery capacity (J); inf = unlimited
    bits: Optional[Tensor] = None  # default payload width (bits/coeff)

    @property
    def n_clients(self) -> int:
        return int(self.freq.shape[0])


def comp_time(profile: DeviceProfile, n_samples) -> Tensor:
    """[N] seconds: T_cmp = C * n_samples / f."""
    return profile.cycles * n_samples / profile.freq


def comp_energy(profile: DeviceProfile, n_samples) -> Tensor:
    """[N] Joules: E_cmp = kappa * C * n_samples * f^2 (per round)."""
    return profile.kappa * profile.cycles * n_samples * profile.freq ** 2


def uniform_profile(n: int, *, freq_hz: float = DEFAULT_FREQ_HZ,
                    kappa: float = DEFAULT_KAPPA,
                    cycles: float = DEFAULT_CYCLES,
                    battery_j: float = UNLIMITED_J,
                    bits: Optional[float] = None) -> DeviceProfile:
    """Homogeneous fleet: every device at the same operating point."""
    full = lambda v: torch.full((n,), v, dtype=torch.float32)  # noqa: E731
    return DeviceProfile(freq=full(freq_hz), kappa=full(kappa),
                         cycles=full(cycles), battery=full(battery_j),
                         bits=None if bits is None else full(float(bits)))


def tiered_profile(n: int, *, seed: int = 0,
                   tiers: Sequence[Tuple[str, float, float, float]] = DEFAULT_TIERS,
                   battery_j: float = UNLIMITED_J,
                   tier_bits: Optional[Sequence[float]] = None) -> DeviceProfile:
    """Heterogeneous fleet: each client drawn uniformly into a CPU tier,
    pure in ``seed``; ``tier_bits`` (aligned with ``tiers``) attaches
    per-tier default uplink widths to the same draw."""
    rng = np.random.default_rng(seed + _TIER_STREAM)
    idx = rng.integers(0, len(tiers), n)
    pick = lambda col: _f32([tiers[i][col] for i in idx])  # noqa: E731
    bits = None
    if tier_bits is not None:
        if len(tier_bits) != len(tiers):
            raise ValueError(f"tier_bits has {len(tier_bits)} entries for "
                             f"{len(tiers)} tiers")
        bits = _f32([float(tier_bits[i]) for i in idx])
    return DeviceProfile(freq=pick(1), kappa=pick(2), cycles=pick(3),
                         battery=torch.full((n,), battery_j,
                                            dtype=torch.float32),
                         bits=bits)


def with_batteries(profile: DeviceProfile, capacity_j, *,
                   seed: int = 0) -> DeviceProfile:
    """Finite batteries: a scalar capacity, an [N] list/array, or a
    (lo, hi) *tuple* drawn uniformly per client (own rng stream, pure in
    seed)."""
    if isinstance(capacity_j, tuple) and len(capacity_j) == 2:
        lo, hi = capacity_j
        if not lo <= hi:
            raise ValueError(f"battery range lo <= hi required, got "
                             f"({lo}, {hi})")
        rng = np.random.default_rng(seed + _BATTERY_STREAM)
        cap = rng.uniform(lo, hi, profile.n_clients)
    else:
        cap = np.broadcast_to(np.asarray(capacity_j, np.float32),
                              (profile.n_clients,))
    return profile._replace(battery=_f32(cap))


def make_profile(kind: Optional[str], n: int, *, seed: int = 0,
                 battery_j: float = UNLIMITED_J) -> Optional[DeviceProfile]:
    """String-keyed constructor: "uniform" | "tiered" | "tiered-q"
    (tiered with the DEFAULT_TIER_BITS widths) | None."""
    if kind is None or kind == "none":
        return None
    if kind == "uniform":
        return uniform_profile(n, battery_j=battery_j)
    if kind == "tiered":
        return tiered_profile(n, seed=seed, battery_j=battery_j)
    if kind in ("tiered-q", "tiered_q"):
        return tiered_profile(n, seed=seed, battery_j=battery_j,
                              tier_bits=DEFAULT_TIER_BITS)
    raise ValueError(f"unknown device profile kind {kind!r}; "
                     "expected 'uniform', 'tiered', 'tiered-q', or None")


def alive_mask(battery: Tensor) -> Tensor:
    """[N] bool: clients with charge left (inf is always alive)."""
    return battery > 0.0
