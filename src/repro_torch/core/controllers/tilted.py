"""Tilted-ERM / q-FFL-style fairness baseline controller.

Clients are sampled without replacement with probability proportional to
``exp(t z_i)``, ``z_i`` the client's score EMA (update norms) normalized by
its mean: a Gumbel-top-K draw from ``obs.key``. The transmission side is
the other fixed-K baselines': gamma = 1 and an equal ``B_tot / K`` split.
``t = 0`` is uniform random-K; a large ``t`` approaches worst-score-first.

State is the [N] score EMA (``TiltedState``); ``reset_clients`` gives
(re)arrived lanes the fresh zero score.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ... import random as prng
from .base import (ControllerContext, RoundObservation, masked_decision,
                   register_controller, topk_mask)

Tensor = torch.Tensor


class TiltedState(NamedTuple):
    s: Tensor    # [N] score EMA (u-norm scale; 0 = fresh client)


@register_controller("tilted")
class TiltedFair:
    """Stochastic K-subset selection ∝ exp(tilt * normalized score EMA)."""

    def __init__(self, ctx: ControllerContext):
        self.ctx = ctx
        self.tilt = float(ctx.tilt_t)
        self.ema = float(ctx.tilt_ema)

    def init(self, n_clients: int) -> TiltedState:
        return TiltedState(s=torch.zeros(n_clients, dtype=torch.float32,
                                         device=self.ctx.device))

    def decide(self, obs: RoundObservation, state: TiltedState):
        ctx = self.ctx
        s_new = (1.0 - self.ema) * state.s + self.ema * obs.u_norms
        # normalized by the mean so the tilt temperature is scale-free (the
        # Python scalar keeps the sum in float32, as in the reference)
        z = s_new / (torch.mean(s_new) + 1e-12)
        logits = self.tilt * z
        if obs.alive is not None:
            logits = torch.where(obs.alive, logits, -torch.inf)
        # Gumbel top-K == K clients without replacement ∝ e^logits
        g = logits + prng.gumbel(obs.key, tuple(logits.shape)).to(logits.device)
        x = topk_mask(g, ctx.k)
        gamma = torch.ones_like(obs.u_norms)
        bw = torch.full_like(obs.u_norms, ctx.b_tot / max(ctx.k, 1))
        return masked_decision(x, gamma, bw, obs, ctx), TiltedState(s=s_new)

    def reset_clients(self, state: TiltedState, mask) -> TiltedState:
        """Open-population hook: (re)arrived slots start from the fresh
        zero score, not the departed occupant's EMA."""
        return TiltedState(s=torch.where(mask, 0.0, state.s))
