"""Fault injection and graceful degradation for the FairEnergy FL loop.

The port's copy of ``repro.core.faults``. Three layers, composed by the
trainer in ``repro_torch.fl.server``:

* :mod:`config` — ``FaultConfig``, the adversarial-simulator knobs
  (crash / corruption / channel-estimate error / open-population churn);
* :mod:`inject` — (seed, round)-pure draws for each fault stream;
* :mod:`defense` — the registered aggregator layer (``"mean"`` legacy
  weighted mean, ``"defended"`` finite screen + norm clip + trimmed mean)
  plus ``DefenseConfig`` / ``DefenseState``.

A disabled ``FaultConfig`` together with the ``"mean"`` aggregator leaves
the legacy round unchanged.
"""
from .config import CORRUPT_MODES, FaultConfig
from .defense import (DefendedAggregator, DefenseConfig, DefenseState,
                      MeanAggregator, available_aggregators,
                      init_defense_state, make_aggregator,
                      register_aggregator)
from .inject import (arrival_mask, channel_estimate, corrupt_draw,
                     corrupt_payload, crash_draw, presence_mask)

__all__ = [
    "CORRUPT_MODES",
    "FaultConfig",
    "DefenseConfig",
    "DefenseState",
    "DefendedAggregator",
    "MeanAggregator",
    "available_aggregators",
    "init_defense_state",
    "make_aggregator",
    "register_aggregator",
    "arrival_mask",
    "channel_estimate",
    "corrupt_draw",
    "corrupt_payload",
    "crash_draw",
    "presence_mask",
]
