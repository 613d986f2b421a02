"""Registry-based per-round controllers (selection + bandwidth + compression).

    from repro_torch.core.controllers import ControllerContext, make_controller
    ctx = ControllerContext(n_clients=50, b_tot=10e6, s_bits=6.4e7,
                            i_bits=2e6, n0=4e-21, fe_cfg=FairEnergyConfig(),
                            device="cuda")          # or "cpu"
    ctrl = make_controller("fairenergy", ctx)
    state = ctrl.init(50)
    dec, state = ctrl.decide(obs, state)

Registered: ``fairenergy`` (paper Algorithm 1), ``scoremax``,
``ecorandom``, ``randomfull``, ``channelgreedy`` and ``tilted``.
"""
from .base import (Controller, ControllerContext, RoundDecision,  # noqa: F401
                   RoundObservation, available_controllers, make_controller,
                   masked_decision, register_controller, topk_mask)
from . import baselines, fairenergy, tilted  # noqa: F401  (registration side effects)
from .fairenergy import FairEnergy  # noqa: F401
