"""Async-round configuration: the knobs of the time-aware round.

The port's copy of ``repro.core.rounds.config``, field for field and with
the same checks. ``AsyncConfig`` is a frozen dataclass so it can ride on
trainers, scenarios and CLI flags without aliasing surprises. Its
*disabled* default (infinite deadline, staleness off, no harvesting, no
time tracking) makes the trainer run the exact legacy round.
``resolve_deadline`` is host arithmetic, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ...xla_math import log1p_xla
from ..channel import LN2, RATE_B_FLOOR_HZ, payload_bits


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Knobs of the asynchronous round subsystem.

    deadline_s: round deadline T_round in simulated seconds. ``inf``
        (default) never drops anybody.
    deadline_q: if set, resolve the deadline automatically as this
        quantile of the clients' *estimated* round times (comp time +
        full-payload comm time at an even bandwidth split; see
        ``resolve_deadline``) — overrides ``deadline_s``. A value around
        0.5 makes the slower half of the fleet miss rounds.
    staleness: buffer late updates and fold them into the round in which
        their (background) transmission completes, discounted by
        ``staleness_weight(age, staleness_a)``. Late clients are charged
        their full round energy (the transmission does finish — just
        late).
    staleness_a: polynomial decay exponent a in w(tau) = 1/(1+tau)^a.
    harvest_j: mean per-round harvested energy (J) — batteries recharge
        after each round by a (seed, round)-pure exponential draw with a
        per-client mean proportional to the device tier
        (``harvest.harvest_rates``), capped at capacity. None disables.
    track_time: emit per-round simulated wall-clock (and late/stale
        counts) even when the deadline is infinite — the synchronous
        baseline arm of the wall-clock comparisons.
    """
    deadline_s: float = math.inf
    deadline_q: Optional[float] = None
    staleness: bool = False
    staleness_a: float = 0.5
    harvest_j: Optional[float] = None
    track_time: bool = False

    def __post_init__(self):
        if self.deadline_s <= 0.0 and not self.deadline_s == 0.0:
            raise ValueError(f"deadline_s must be >= 0, got {self.deadline_s}")
        if self.deadline_q is not None and not 0.0 < self.deadline_q <= 1.0:
            raise ValueError(f"deadline_q must be in (0, 1], got "
                             f"{self.deadline_q}")
        if self.staleness_a < 0.0:
            raise ValueError(f"staleness_a must be >= 0, got "
                             f"{self.staleness_a}")
        if self.harvest_j is not None and self.harvest_j < 0.0:
            raise ValueError(f"harvest_j must be >= 0, got {self.harvest_j}")

    @property
    def enabled(self) -> bool:
        """Any knob active? False => the trainer runs the exact legacy
        (bulk-synchronous, untimed) round."""
        return (math.isfinite(self.deadline_s) or self.deadline_q is not None
                or self.staleness or self.harvest_j is not None
                or self.track_time)


def resolve_deadline(q: float, *, t_cmp, P, h, b_tot: float, s_bits: float,
                     i_bits: float, n0: float, k: int) -> float:
    """Deadline (s) as the ``q``-quantile of estimated client round times.

    The estimate is deterministic (no fading): comp time plus the
    full-payload (gamma = 1) transmission time at an even split of the
    bandwidth budget over ``k`` expected selections. The rate is float32
    (as the reference computes it without x64); the payload, the sum and
    the quantile are float64. Pure in its inputs, so a
    scenario preset resolves to the same deadline on every run."""
    b_each = b_tot / max(int(k), 1)
    f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32))  # noqa: E731
    # the channel model's rate as the reference evaluates it on host
    # arrays, op by op: P * h in float64 (numpy), the rest in float32 with
    # XLA's log1p. A quantile deadline sits on one client's estimate, so
    # its last bit is the reference's
    B = torch.clamp(torch.tensor(b_each, dtype=torch.float32),
                    min=RATE_B_FLOOR_HZ)
    ph = f32(np.asarray(P, np.float64) * np.asarray(h, np.float64))
    rate = (B * log1p_xla(ph / (n0 * B)) / LN2).numpy()
    bits = float(payload_bits(1.0, s_bits, i_bits))      # Python floats
    t_est = np.asarray(t_cmp, np.float64) + bits / np.maximum(rate, 1e-9)
    return float(np.quantile(t_est, q))
