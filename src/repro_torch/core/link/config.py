"""Link-reliability configuration: the knobs of the lossy-uplink simulator.

The port's copy of ``repro.core.link.config``, field for field and with
the same checks. Its *disabled* default (no outage model, no burst
interference) makes the trainer run the exact legacy round.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LinkConfig:
    """Knobs of the link-reliability subsystem (``core.link``).

    outage: master switch for the per-attempt packet-error model. Each
        transmission attempt of a selected client fails with the
        Rayleigh-outage probability of its realized SNR at the decided
        ``(b*, gamma*)`` operating point (``model.outage_probability``);
        failed attempts are retransmitted up to ``max_retx`` times, each
        charging real airtime and energy. False disables outage/retx
        entirely (bursts can still run alone).
    fade_margin_db: link-budget fade margin in dB. The per-attempt fast
        fade has mean SNR ``margin x`` the design SNR, so a larger margin
        means rarer outage (``p_out = 1 - exp(-1/margin)`` on a truthful
        channel estimate). Negative margins model an over-optimistic
        link budget.
    max_retx: retransmissions allowed after the first attempt (total
        attempts = ``max_retx + 1``). A client whose every attempt fails
        is *retx-exhausted*: its update is dropped (never aggregated) but
        its energy and fairness-EMA effects land honestly.
    backoff_s: backoff slot in seconds inserted before each
        retransmission — pure added latency, charged into the round
        wall-clock and the deadline feasibility check but not powered.
    burst_p: per-round probability that a quiet client enters the burst
        state of the two-state Gilbert-Elliott interference chain.
        0 disables the interference stream.
    burst_q: per-round probability that a bursting client recovers to
        quiet. The stationary burst fraction is ``p / (p + q)`` and the
        mean burst length ``1 / q`` rounds.
    i_burst_n0: burst interference density in units of the thermal noise
        floor: in the burst state the effective noise rises
        ``N0 -> N0 * (1 + i_burst_n0)`` in the *physics* (the comm time
        and energy actually charged). 0 disables.
    observe_burst: whether the controller's channel observation reflects
        the burst. False (default) models interference the estimator
        cannot see — the controller prices the quiet-state channel while
        the realized transmission pays the degraded one (the same
        belief/physics split as ``FaultConfig.h_err_std``).
    price_outage: fold the expected-attempt factor ``1 / (1 - p_out)``
        into the solver's comm-energy pricing, so the controller's
        energy-fairness tradeoff sees the true expected cost of a lossy
        link. Requires ``outage``.

    All draws are (seed, round)-pure (attempts additionally pure in the
    attempt index): private ``fold_in`` streams off the trainer's link
    key — the same purity contract as fading, batch sampling,
    harvesting, and fault injection.
    """
    outage: bool = False
    fade_margin_db: float = 6.0
    max_retx: int = 2
    backoff_s: float = 0.0
    burst_p: float = 0.0
    burst_q: float = 0.5
    i_burst_n0: float = 0.0
    observe_burst: bool = False
    price_outage: bool = False

    def __post_init__(self):
        if self.max_retx < 0:
            raise ValueError(f"max_retx must be >= 0, got {self.max_retx}")
        if self.backoff_s < 0.0:
            raise ValueError(f"backoff_s must be >= 0, got {self.backoff_s}")
        for name in ("burst_p", "burst_q"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.i_burst_n0 < 0.0:
            raise ValueError(f"i_burst_n0 must be >= 0, got "
                             f"{self.i_burst_n0}")
        if self.price_outage and not self.outage:
            raise ValueError("price_outage requires outage=True (there is "
                             "no p_out to price on a lossless link)")

    @property
    def bursty(self) -> bool:
        """Is the Gilbert-Elliott interference stream active?"""
        return self.burst_p > 0.0 and self.i_burst_n0 > 0.0

    @property
    def enabled(self) -> bool:
        """Any link impairment active? False => the trainer runs the
        exact legacy (lossless-link) round."""
        return self.outage or self.bursty
