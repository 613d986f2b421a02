"""Wireless link reliability for the FairEnergy FL loop (the port's copy of
``repro.core.link``).

* :mod:`config` — ``LinkConfig``, the lossy-uplink knobs (per-attempt
  Rayleigh outage, bounded HARQ retransmission with backoff,
  Gilbert-Elliott bursty interference, outage-aware solver pricing);
* :mod:`model` — (seed, round[, attempt])-pure draws and the carried
  ``LinkState`` (the per-client burst chain).

A disabled ``LinkConfig`` leaves the trainer's legacy round unchanged.
"""
from .config import LinkConfig
from .model import (PRICE_P_CAP, LinkState, attempt_energy, attempt_outcomes,
                    attempt_time, burst_channel, burst_step,
                    expected_attempts, init_link_state, outage_probability)

__all__ = [
    "LinkConfig",
    "LinkState",
    "PRICE_P_CAP",
    "attempt_energy",
    "attempt_outcomes",
    "attempt_time",
    "burst_channel",
    "burst_step",
    "expected_attempts",
    "init_link_state",
    "outage_probability",
]
