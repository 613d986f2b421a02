"""FairEnergy as a registered controller.

Thin adapter over ``repro_torch.core.fairenergy.solve_round`` (Algorithm 1)
so the paper's controller plugs into the registry. ``init`` embeds the
solver scalars (``FEParams``) into the carried ``ControllerState``;
``decide`` forwards to ``solve_round`` reading that state.

eta_auto calibration (round 0: scale the score weight so the median score
benefit matches the median energy cost at gamma=0.5, B=B_tot/N) is a
host-side, one-shot step: ``calibrate`` freezes ``eta`` into the config,
so callers rebuild the controller state after calibrating (the trainer
re-inits it).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..channel import comm_energy_eager
from ..fairenergy import init_state, solve_round
from .base import ControllerContext, RoundObservation, register_controller


@register_controller("fairenergy")
class FairEnergy:
    def __init__(self, ctx: ControllerContext):
        if ctx.fe_cfg is None:
            raise ValueError("FairEnergy controller requires ctx.fe_cfg")
        self.ctx = ctx
        self.fe_cfg = ctx.fe_cfg

    def init(self, n_clients: int):
        ctx = self.ctx
        return init_state(self.fe_cfg, n_clients, b_tot=ctx.b_tot,
                          s_bits=ctx.s_bits, i_bits=ctx.i_bits, n0=ctx.n0,
                          e_cmp=ctx.e_cmp_array(), device=ctx.device)

    @property
    def needs_calibration(self) -> bool:
        return bool(self.fe_cfg.eta_auto)

    def calibrate(self, u_norms, h, P) -> None:
        """eta_auto: eta := eta_rel * median_i [E_cmm,i(gamma=.5,
        B=B_tot/N) + E_cmp,i] / median_i s_i(.5), from host arrays. The
        energies are float32, computed as the reference's eager ops
        compute them (``comm_energy_eager``, C-20), the medians numpy's."""
        ctx = self.ctx
        e = comm_energy_eager(0.5, ctx.b_tot / ctx.n_clients,
                              torch.as_tensor(np.asarray(P, np.float32)),
                              torch.as_tensor(np.asarray(h, np.float32)),
                              ctx.s_bits, ctx.i_bits, ctx.n0).numpy()
        e = e + ctx.e_cmp_array().cpu().numpy()
        s = 0.5 * np.asarray(u_norms, np.float32)
        eta = self.fe_cfg.eta_rel * float(np.median(e)) / max(float(np.median(s)), 1e-12)
        self.fe_cfg = dataclasses.replace(self.fe_cfg, eta=eta, eta_auto=False)

    def decide(self, obs: RoundObservation, state):
        return solve_round(obs.u_norms, obs.h, obs.P, state,
                           fe_cfg=self.fe_cfg, alive=obs.alive,
                           e_scale=obs.e_scale)

    def reset_clients(self, state, mask):
        """Open-population hook (``core.faults``): the masked (newly
        arrived) clients get fresh fairness state — participation EMA back
        to q0, fairness dual back to zero — so a returning slot does not
        inherit the departed occupant's participation debt."""
        q0 = torch.tensor(self.fe_cfg.q0, dtype=torch.float32,
                          device=state.q.device)
        return state._replace(q=torch.where(mask, q0, state.q),
                              mu=torch.where(mask, 0.0, state.mu))

    # ---- sampled decide-path hooks (core.hierarchy) --------------------
    def sampling_deficit(self, state):
        """[N] fairness deficit for candidate-pool sampling: how far each
        client's participation EMA would fall below ``pi_min`` if passed
        over this round, ``max(pi_min - rho q, 0)`` (the greedy repair's
        criterion)."""
        p = state.params
        return torch.clamp(p.pi_min - p.rho * state.q, min=0.0)

    def observe_unsampled(self, state, mask):
        """A client outside the round's pool counts as observed but
        unselected: its participation EMA decays by eq. (1) with x_i = 0
        (``q <- rho q``); its fairness dual stays frozen."""
        p = state.params
        return state._replace(q=torch.where(mask, p.rho * state.q, state.q))
