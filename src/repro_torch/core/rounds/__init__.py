"""Asynchronous rounds: deadlines, staleness, harvesting.

The port's copy of ``repro.core.rounds``. The bulk-synchronous round
closes only when every selected client has returned, and a depleted
client vanishes for good. This package makes *time* a simulated quantity
(Arouj et al., arXiv:2208.04505; BEFL, arXiv:2412.03950):

* **Round deadlines** (``timing``): selected clients whose ``comp_time +
  comm_time`` exceeds the deadline are dropped from the round's aggregate
  and charged only the energy spent up to it — computation first, then
  prorated communication (``partial_round_energy``). Each round logs its
  simulated wall-clock, ``max(selected comp+comm)`` capped at the
  deadline.
* **Staleness-weighted buffered aggregation** (``staleness``): with
  ``staleness=True`` a late update keeps transmitting in the background,
  waits in the carried ``AsyncState`` buffer and folds into the first
  round that closes after its transmission completes, discounted by
  ``w(tau) = 1 / (1 + tau)^a``.
* **Energy harvesting** (``harvest``): batteries recharge between rounds
  by a (seed, round)-pure exponential draw whose mean scales with the
  device tier, so depleted clients can return.

Controllers see time through ``RoundObservation.t_round`` (each client's
best-case round time); the trainer prices deadline-infeasible clients out
through the hard ``alive`` mask. A disabled ``AsyncConfig`` leaves the
legacy round unchanged.
"""
from .config import AsyncConfig, resolve_deadline
from .harvest import apply_harvest, harvest_draw, harvest_rates
from .staleness import AsyncState, init_async_state, staleness_weight
from .timing import (best_case_round_time, partial_round_energy,
                     round_wall_clock)

__all__ = ["AsyncConfig", "AsyncState", "apply_harvest",
           "best_case_round_time", "harvest_draw", "harvest_rates",
           "init_async_state", "partial_round_energy", "resolve_deadline",
           "round_wall_clock", "staleness_weight"]
