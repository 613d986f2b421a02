"""Fault-injection configuration: the knobs of the adversarial simulator.

The port's copy of ``repro.core.faults.config``, field for field and with
the same checks. ``FaultConfig`` is a frozen dataclass like
``core.rounds.AsyncConfig``; its *disabled* default (all rates zero, no
churn, no channel error) makes the trainer run the exact legacy round.
"""
from __future__ import annotations

import dataclasses

CORRUPT_MODES = ("nan", "inf", "scale", "mixed")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Knobs of the fault-injection subsystem (``core.faults``).

    crash_rate: per-round probability that a *selected* client crashes
        mid-round. A crashed client's update never reaches the server and
        its battery is charged only the energy spent up to the crash —
        computation first, then prorated transmission
        (``core.rounds.partial_round_energy``).
    corrupt_rate: per-round probability that a client's *transmitted*
        payload arrives corrupted. Corruption hits the post-sparsify update
        the server receives; the controller's observed update norms stay
        clean.
    corrupt_mode: ``"nan"`` / ``"inf"`` poison every coefficient,
        ``"scale"`` multiplies the row by ``-corrupt_scale`` (a
        sign-flipped outlier), ``"mixed"`` (default) draws one of the three
        per corrupted client.
    corrupt_scale: outlier magnitude for the scaled mode.
    h_err_std: lognormal sigma of the channel-*estimate* error: the
        controller decides on ``h_est = h * exp(sigma * N(0,1))`` while the
        transmission runs on the true ``h``. 0 disables.
    churn_dwell: mean membership epoch length in rounds for the open
        population — each client redraws presence once per ``dwell``
        rounds, with a per-client random phase. 0 disables churn.
    churn_away: per-epoch probability that a client is absent. Departed
        clients join the hard ``alive`` mask; arriving clients get fresh
        fairness state through the controller's ``reset_clients``.

    All draws are (seed, round)-pure: private ``fold_in`` streams off the
    trainer's fault key.
    """
    crash_rate: float = 0.0
    corrupt_rate: float = 0.0
    corrupt_mode: str = "mixed"
    corrupt_scale: float = 1e3
    h_err_std: float = 0.0
    churn_dwell: int = 0
    churn_away: float = 0.3

    def __post_init__(self):
        for name in ("crash_rate", "corrupt_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.corrupt_mode not in CORRUPT_MODES:
            raise ValueError(f"corrupt_mode must be one of {CORRUPT_MODES}, "
                             f"got {self.corrupt_mode!r}")
        if self.corrupt_scale <= 0.0:
            raise ValueError(f"corrupt_scale must be > 0, got "
                             f"{self.corrupt_scale}")
        if self.h_err_std < 0.0:
            raise ValueError(f"h_err_std must be >= 0, got {self.h_err_std}")
        if self.churn_dwell < 0:
            raise ValueError(f"churn_dwell must be >= 0, got "
                             f"{self.churn_dwell}")
        if not 0.0 <= self.churn_away < 1.0:
            raise ValueError(f"churn_away must be in [0, 1), got "
                             f"{self.churn_away}")

    @property
    def enabled(self) -> bool:
        """Any fault stream active? False => the legacy fault-free round."""
        return (self.crash_rate > 0.0 or self.corrupt_rate > 0.0
                or self.h_err_std > 0.0 or self.churn_dwell > 0)
