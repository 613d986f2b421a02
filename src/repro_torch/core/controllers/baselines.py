"""Baseline controllers (paper Sec. VII).

* **ScoreMax** — the top-K contribution scores, full precision (gamma=1),
  B_tot split equally among the K selected.
* **EcoRandom** — K random clients, each transmitting at the minimum
  compression ratio and the bandwidth observed for FairEnergy (the
  communication-cost floor).
* extras: **RandomFull** (random K, gamma=1, equal bandwidth) and
  **ChannelGreedy** (FedCS-style: the K best channels first).

K is fixed to the mean number of clients FairEnergy selects a round.
All four are stateless (``init`` returns ``()``); the random K-subset is
drawn from ``obs.key`` with ``repro_torch.random``, so a run is
reproducible from the trainer seed alone and draws the JAX package's
subsets.
"""
from __future__ import annotations

import torch

from ... import random as prng
from .base import (ControllerContext, RoundObservation, masked_decision,
                   register_controller, topk_mask)


class _StatelessController:
    def __init__(self, ctx: ControllerContext):
        self.ctx = ctx

    def init(self, n_clients: int):
        return ()

    @staticmethod
    def _demote_dead(scores, obs: RoundObservation):
        """Rank depleted clients below every live one (``obs.alive`` is
        None outside battery scenarios); the trainer's hard mask drops any
        dead client a short live set still reaches."""
        if obs.alive is None:
            return scores
        return torch.where(obs.alive, scores, -torch.inf)

    def _random_k_mask(self, obs: RoundObservation):
        """A uniform random K-subset (of the live clients): the K smallest
        of N iid uniforms drawn from ``obs.key``."""
        u = prng.uniform(obs.key, tuple(obs.u_norms.shape)).to(obs.u_norms.device)
        return topk_mask(self._demote_dead(-u, obs), self.ctx.k)

    def _full_split(self, like):
        """gamma = 1 and B_tot / K for every client."""
        ctx = self.ctx
        return (torch.ones_like(like),
                torch.full_like(like, ctx.b_tot / max(ctx.k, 1)))


@register_controller("scoremax")
class ScoreMax(_StatelessController):
    def decide(self, obs: RoundObservation, state):
        x = topk_mask(self._demote_dead(obs.u_norms, obs), self.ctx.k)
        gamma, bw = self._full_split(obs.u_norms)
        return masked_decision(x, gamma, bw, obs, self.ctx), state


@register_controller("ecorandom")
class EcoRandom(_StatelessController):
    def decide(self, obs: RoundObservation, state):
        ctx = self.ctx
        x = self._random_k_mask(obs)
        gamma = torch.full_like(obs.u_norms, ctx.eco_gamma)
        bw = torch.full_like(obs.u_norms, ctx.eco_bw)
        return masked_decision(x, gamma, bw, obs, ctx), state


@register_controller("randomfull")
class RandomFull(_StatelessController):
    def decide(self, obs: RoundObservation, state):
        x = self._random_k_mask(obs)
        gamma, bw = self._full_split(obs.u_norms)
        return masked_decision(x, gamma, bw, obs, self.ctx), state


@register_controller("channelgreedy")
class ChannelGreedy(_StatelessController):
    """FedCS-like: the K best instantaneous channels, gamma = 1."""

    def decide(self, obs: RoundObservation, state):
        x = topk_mask(self._demote_dead(obs.h, obs), self.ctx.k)
        gamma, bw = self._full_split(obs.h)
        return masked_decision(x, gamma, bw, obs, self.ctx), state
