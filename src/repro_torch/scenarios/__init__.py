"""Named experiment scenarios: device fleets x data skew x channel.

The port's copy of ``repro.scenarios``: the ``Scenario`` dataclass with
all its fields, the registry and every preset.

A ``Scenario`` composes the knobs that define a workload — the device
profile kind (``core.energy``), finite-battery draws, the Dirichlet
partition concentration, and fading — into a preset addressable by name
(``fl_experiments --scenario tiered-devices``). Presets:

=====================  =======================================================
``uniform``            homogeneous 1 GHz fleet, comp energy on, no battery cap
``tiered-devices``     low/mid/high CPU tiers (16x comp-energy spread)
``battery-constrained``  tiered fleet + finite batteries (clients deplete and
                       drop out mid-training)
``deep-noniid``        homogeneous fleet + Dirichlet beta = 0.05 label skew
``straggler``          tiered fleet + median round deadline + staleness-
                       weighted buffering of late updates
``harvesting``         tiered fleet + finite batteries + per-round energy
                       harvesting (depleted clients recharge and return)
``churn``              tiered fleet + open population (4-round dwell
                       epochs, 30% away) + 5% mid-round crash rate
``byzantine-lite``     15% corrupted payloads + noisy channel estimates,
                       defended aggregation on
``mobility``           tiered fleet of moving clients (3 dB RMS slow
                       pathloss drift on top of Rayleigh fading)
``lossy-uplink``       Rayleigh packet outages + bounded HARQ
                       retransmission charging real airtime energy
``bursty-interference``  Gilbert-Elliott interference bursts raising the
                       noise floor 20 dB, plus outages/retransmission
``quantized``          tiered fleet with joint (gamma, bits) compression:
                       the solver picks a {8, 16, 32}-bit width per client
                       alongside gamma and the engine transmits symmetric
                       fixed-point payloads at the decided width
=====================  =======================================================

Everything a scenario draws (tier assignment, battery capacity) is a pure
function of the seed via private rng streams, so attaching a scenario
never perturbs the channel model's power/distance/fading draws. Without a
scenario (``device_profile=None``) the system reproduces the legacy
communication-only physics bit-for-bit.

Register custom scenarios with ``register_scenario(Scenario(...))``;
lookups normalize case and ``_``/``-`` (``deep-nonIID`` == ``deep_noniid``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from ..core.energy import (DEFAULT_TIER_BITS, DeviceProfile, tiered_profile,
                           uniform_profile, with_batteries)

@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named composition of device fleet, data skew, and channel knobs."""
    name: str
    description: str
    profile: str = "uniform"                 # "none" | "uniform" | "tiered"
    battery_j: Optional[Tuple[float, float]] = None  # per-client U[lo, hi] J
    dirichlet_beta: Optional[float] = None   # None = caller's default
    rayleigh: Optional[bool] = None          # None = caller's default
    # --- async-round knobs (repro.core.rounds) --------------------------
    deadline_s: Optional[float] = None       # fixed round deadline (s)
    deadline_q: Optional[float] = None       # or: quantile-resolved deadline
    staleness: bool = False                  # buffer late updates
    staleness_a: float = 0.5                 # w(tau) = (1 + tau)^-a
    harvest_j: Optional[float] = None        # mean per-round recharge (J)
    # --- fault-injection knobs (repro.core.faults) ----------------------
    crash_rate: float = 0.0                  # P[mid-round crash | selected]
    corrupt_rate: float = 0.0                # P[payload corrupted | made]
    corrupt_mode: str = "mixed"              # nan | inf | scale | mixed
    corrupt_scale: float = 1e3               # outlier multiplier ("scale")
    h_err_std: float = 0.0                   # log-normal channel-est. error
    churn_dwell: int = 0                     # open-population epoch (rounds)
    churn_away: float = 0.3                  # P[departed | epoch]
    defended: bool = False                   # robust aggregation on
    trim_frac: float = 0.0                   # coord-wise trimmed mean frac
    # --- mobility knobs (repro.core.channel) ----------------------------
    mobility_sigma_db: float = 0.0           # RMS pathloss drift (dB); 0=off
    mobility_period: float = 40.0            # rounds per slowest drift cycle
    # --- quantized-payload knobs (repro.fl.compression / fairenergy) ----
    bits_grid: Optional[Tuple[float, ...]] = None  # joint (gamma, bits)
    #                                          decision grid; None = caller's
    tier_bits: bool = False                  # per-tier default uplink widths
    #                                          (DEFAULT_TIER_BITS) on tiered
    #                                          profiles
    # --- link-reliability knobs (repro.core.link) -----------------------
    link_outage: bool = False                # Rayleigh packet-error outages
    fade_margin_db: float = 6.0              # link-budget fade margin (dB)
    max_retx: int = 2                        # HARQ retransmission budget
    link_backoff_s: float = 0.0              # backoff slot between attempts
    burst_p: float = 0.0                     # P[quiet -> burst] per round
    burst_q: float = 0.5                     # P[burst -> quiet] per round
    i_burst_n0: float = 0.0                  # burst interference / N0
    observe_burst: bool = False              # controller sees burst channel
    price_outage: bool = False               # expected-attempt solver pricing

    def device_profile(self, n: int, seed: int = 0) -> Optional[DeviceProfile]:
        """Build the [n]-client fleet, pure in ``seed``."""
        if self.profile == "none":
            prof = None
        elif self.profile == "uniform":
            prof = uniform_profile(n)
        elif self.profile == "tiered":
            prof = tiered_profile(
                n, seed=seed,
                tier_bits=DEFAULT_TIER_BITS if self.tier_bits else None)
        else:
            raise ValueError(f"scenario {self.name!r}: unknown profile kind "
                             f"{self.profile!r}")
        if self.battery_j is not None:
            if prof is None:
                prof = uniform_profile(n)
            prof = with_batteries(prof, self.battery_j, seed=seed)
        return prof

    def apply_channel(self, ch_cfg):
        """ChannelConfig with this scenario's overrides applied."""
        if self.rayleigh is not None:
            ch_cfg = dataclasses.replace(ch_cfg, rayleigh=self.rayleigh)
        return ch_cfg

    def apply_fe(self, fe_cfg):
        """FairEnergyConfig with this scenario's overrides applied: a
        preset ``bits_grid`` widens the solver's decision grid to the
        joint (gamma, bits) levels. None leaves the caller's config (and
        its compiled program) untouched."""
        if self.bits_grid is not None:
            fe_cfg = dataclasses.replace(
                fe_cfg, bits_grid=tuple(float(b) for b in self.bits_grid))
        return fe_cfg

    def beta(self, default: float) -> float:
        return self.dirichlet_beta if self.dirichlet_beta is not None else default

    def async_config(self, *, deadline_s: Optional[float] = None,
                     staleness_a: Optional[float] = None):
        """The scenario's ``core.rounds.AsyncConfig`` (None when no async
        knob is set — the trainer then runs the exact legacy synchronous
        round). Explicit CLI overrides win over the preset: ``deadline_s``
        replaces both preset deadline knobs."""
        from ..core.rounds import AsyncConfig
        d_s, d_q = self.deadline_s, self.deadline_q
        if deadline_s is not None:
            d_s, d_q = deadline_s, None
        a = staleness_a if staleness_a is not None else self.staleness_a
        cfg = AsyncConfig(
            deadline_s=d_s if d_s is not None else math.inf,
            deadline_q=d_q, staleness=self.staleness, staleness_a=a,
            harvest_j=self.harvest_j)
        return cfg if cfg.enabled else None

    def fault_config(self, *, crash_rate: Optional[float] = None,
                     corrupt_rate: Optional[float] = None):
        """The scenario's ``core.faults.FaultConfig`` (None when no fault
        knob is set — the legacy fault-free round). Explicit CLI overrides
        win over the preset."""
        from ..core.faults import FaultConfig
        cfg = FaultConfig(
            crash_rate=crash_rate if crash_rate is not None else self.crash_rate,
            corrupt_rate=(corrupt_rate if corrupt_rate is not None
                          else self.corrupt_rate),
            corrupt_mode=self.corrupt_mode, corrupt_scale=self.corrupt_scale,
            h_err_std=self.h_err_std, churn_dwell=self.churn_dwell,
            churn_away=self.churn_away)
        return cfg if cfg.enabled else None

    def mobility_config(self, *, sigma_db: Optional[float] = None):
        """The scenario's ``core.channel.MobilityConfig`` (None when
        mobility is off — the static channel). ``sigma_db`` overrides the
        preset in either direction (0 disables)."""
        s = sigma_db if sigma_db is not None else self.mobility_sigma_db
        if s <= 0.0:
            return None
        from ..core.channel import MobilityConfig
        return MobilityConfig(sigma_db=s, period_rounds=self.mobility_period)

    def link_config(self, *, max_retx: Optional[int] = None,
                    burst_p: Optional[float] = None,
                    price_outage: Optional[bool] = None):
        """The scenario's ``core.link.LinkConfig`` (None when no
        link knob is set — the trainer then runs the exact legacy
        lossless-uplink round). Explicit CLI overrides win over the
        preset."""
        from ..core.link import LinkConfig
        cfg = LinkConfig(
            outage=self.link_outage,
            fade_margin_db=self.fade_margin_db,
            max_retx=max_retx if max_retx is not None else self.max_retx,
            backoff_s=self.link_backoff_s,
            burst_p=burst_p if burst_p is not None else self.burst_p,
            burst_q=self.burst_q, i_burst_n0=self.i_burst_n0,
            observe_burst=self.observe_burst,
            price_outage=(price_outage if price_outage is not None
                          else self.price_outage))
        return cfg if cfg.enabled else None

    def defense_config(self, *, defended: Optional[bool] = None):
        """The scenario's ``core.faults.DefenseConfig`` (None when defense
        is off — aggregation stays the legacy weighted mean). ``defended``
        overrides the preset in either direction."""
        on = defended if defended is not None else self.defended
        if not on:
            return None
        from ..core.faults import DefenseConfig
        return DefenseConfig(trim_frac=self.trim_frac)


_REGISTRY: dict[str, Scenario] = {}


def _norm(name: str) -> str:
    return name.lower().replace("_", "-")


def register_scenario(scenario: Scenario) -> Scenario:
    key = _norm(scenario.name)
    if key in _REGISTRY:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    _REGISTRY[key] = scenario
    return scenario


def available_scenarios() -> list[str]:
    return sorted(_REGISTRY)


def get_scenario(name: str) -> Scenario:
    try:
        return _REGISTRY[_norm(name)]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; available: "
                       f"{available_scenarios()}") from None


register_scenario(Scenario(
    name="uniform",
    description="homogeneous 1 GHz fleet; computation energy priced, "
                "unlimited batteries",
    profile="uniform"))

register_scenario(Scenario(
    name="tiered-devices",
    description="low/mid/high CPU tiers (0.5/1/2 GHz): 16x comp-energy "
                "spread across clients",
    profile="tiered"))

register_scenario(Scenario(
    name="battery-constrained",
    description="tiered fleet with finite U[20, 80] mJ batteries — "
                "clients deplete and become unselectable",
    profile="tiered", battery_j=(0.02, 0.08)))

register_scenario(Scenario(
    name="deep-noniid",
    description="homogeneous fleet, Dirichlet beta=0.05 label skew "
                "(near single-label client shards)",
    profile="uniform", dirichlet_beta=0.05))

register_scenario(Scenario(
    name="straggler",
    description="tiered fleet under a median-round-time deadline: slow "
                "clients miss rounds; their late updates fold in later "
                "with the w(tau) = (1+tau)^-0.5 staleness discount",
    profile="tiered", deadline_q=0.5, staleness=True, staleness_a=0.5))

register_scenario(Scenario(
    name="churn",
    description="tiered fleet under an open population: clients depart / "
                "(re)arrive on 4-round dwell epochs (30% away) and 5% of "
                "selected clients crash mid-round, paying partial energy "
                "and dropping their update",
    profile="tiered", churn_dwell=4, churn_away=0.3, crash_rate=0.05))

register_scenario(Scenario(
    name="byzantine-lite",
    description="homogeneous fleet where 15% of delivered updates are "
                "corrupted (NaN/Inf/1e3-scaled outliers) and the "
                "controller sees a noisy channel estimate (sigma=0.25 "
                "log-normal); defended aggregation (finite screen + "
                "norm clipping + 10% coordinate-wise trim) is on",
    profile="uniform", corrupt_rate=0.15, corrupt_mode="mixed",
    h_err_std=0.25, defended=True, trim_frac=0.1))

register_scenario(Scenario(
    name="mobility",
    description="tiered fleet of moving clients: slow (seed, round)-pure "
                "log-normal pathloss drift (3 dB RMS shadowing, ~30-round "
                "cycles) on top of per-round Rayleigh fading",
    profile="tiered", mobility_sigma_db=3.0, mobility_period=30.0))

register_scenario(Scenario(
    name="lossy-uplink",
    description="tiered fleet over an unreliable uplink: Rayleigh packet "
                "outages against a 5 dB fade margin, up to 2 HARQ "
                "retransmissions per round (50 ms backoff slots) charging "
                "real airtime energy; exhausted clients drop their update",
    profile="tiered", link_outage=True, fade_margin_db=5.0, max_retx=2,
    link_backoff_s=0.05))

register_scenario(Scenario(
    name="bursty-interference",
    description="tiered fleet under Gilbert-Elliott bursty interference: "
                "a (seed, round)-pure two-state chain (p=0.15, q=0.45) "
                "raises the effective noise floor 20 dB in the burst "
                "state while the controller still prices the quiet-state "
                "channel; Rayleigh outages + 2 HARQ retransmissions",
    profile="tiered", link_outage=True, fade_margin_db=6.0, max_retx=2,
    burst_p=0.15, burst_q=0.45, i_burst_n0=99.0))

register_scenario(Scenario(
    name="quantized",
    description="tiered fleet with joint (gamma, bits) compression: the "
                "solver picks a quantization width from {8, 16, 32} per "
                "client alongside gamma — the payload charges "
                "gamma*S*(bits/32) + I and the score is fidelity-"
                "discounted by (1 - 2^(1-bits)) — and the engine "
                "transmits symmetric fixed-point updates at the decided "
                "width; tier-default widths cover non-joint controllers",
    profile="tiered", bits_grid=(8.0, 16.0, 32.0), tier_bits=True))

register_scenario(Scenario(
    name="harvesting",
    description="tiered fleet, finite U[20, 80] mJ batteries, ~2 mJ/round "
                "mean energy harvesting — depleted clients recharge and "
                "re-enter selection",
    profile="tiered", battery_j=(0.02, 0.08), harvest_j=2e-3))
