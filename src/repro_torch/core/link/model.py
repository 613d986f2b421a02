"""(seed, round)-pure link draws: burst interference, outage, retries.

The port's copy of ``repro.core.link.model``. Every function folds a
private stream tag and then the round index into the trainer's link key
before drawing (``repro_torch.random``, which reproduces ``jax.random``'s
uniforms bit for bit), so the realized link behaviour is a pure function
of (seed, round) — and, for retransmissions, of the attempt index — and
equal to the reference's draws. Keys stay on the host; the uniforms move
to the device of the tensors they are compared with.

The outage model: the decided rate is achievable at the *design* SNR,
proportional to the channel gain the controller believed, ``h_design``.
Each attempt rides an independent Rayleigh fast fade, an Exp(1) power
factor ``g`` on the *realized* mean SNR ``margin * h_real``, and fails
when the instantaneous SNR undershoots the design point:

    p_out = P[g * margin * h_real < h_design]
          = 1 - exp(-(h_design / h_real) / margin)

Bandwidth and compression cancel out of the threshold, so ``p_out`` is a
per-client scalar, constant across the solver's grid.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ... import random as prng

Tensor = torch.Tensor

_GE_STREAM = 1      # Gilbert-Elliott burst transition uniforms
_OUTAGE_STREAM = 2  # per-attempt outage uniforms

# ceiling on the priced outage probability: keeps the expected-attempt
# factor 1/(1-p) finite (<= 1000x) even when the realized p_out -> 1
PRICE_P_CAP = 0.999


def _f32(v, like: Tensor) -> Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


class LinkState(NamedTuple):
    """Carried link state: the per-client Gilbert-Elliott burst flag."""
    burst: Tensor  # [n] bool — True while the client is in the burst state


def init_link_state(n: int, device=None) -> LinkState:
    """All clients start quiet."""
    return LinkState(burst=torch.zeros(n, dtype=torch.bool, device=device))


def burst_step(key: Tensor, round_idx: int, prev_burst: Tensor, p: float,
               q: float) -> Tensor:
    """One Gilbert-Elliott transition: [n] bool burst mask for this round.
    Quiet clients enter the burst with probability ``p``, bursting
    clients recover with probability ``q``."""
    k = prng.fold_in(prng.fold_in(key, _GE_STREAM), round_idx)
    u = prng.uniform(k, tuple(prev_burst.shape)).to(prev_burst.device)
    return torch.where(prev_burst, u >= _f32(q, u), u < _f32(p, u))


def burst_channel(h: Tensor, burst: Tensor, noise_rise: float) -> Tensor:
    """Effective channel under burst interference: a noise floor raised
    ``N0 -> N0 * F`` is the gain scaled ``h -> h / F``."""
    return torch.where(burst, h / _f32(noise_rise, h), h)


def outage_probability(h_design: Tensor, h_real: Tensor, margin: float
                       ) -> Tensor:
    """[n] per-attempt outage probability; truthful belief gives the
    floor ``1 - exp(-1/margin)``."""
    ratio = h_design / torch.clamp(h_real, min=1e-30)
    return torch.clamp(1.0 - torch.exp(-ratio / _f32(margin, ratio)),
                       0.0, 1.0)


def attempt_outcomes(key: Tensor, round_idx: int, p_out: Tensor,
                     max_retx: int) -> tuple[Tensor, Tensor]:
    """Bounded-HARQ outcome: ([n] int32 attempts used, [n] bool
    delivered), from one uniform per (attempt, client) — shape
    ``[max_retx + 1, n]`` — pure in (key, round). ``delivered`` is False
    exactly for retx-exhausted clients."""
    n_attempts = int(max_retx) + 1
    k = prng.fold_in(prng.fold_in(key, _OUTAGE_STREAM), round_idx)
    u = prng.uniform(k, (n_attempts,) + tuple(p_out.shape)).to(p_out.device)
    fail = (u < p_out[None, :]).to(torch.float32)
    cumfail = torch.cumprod(fail, dim=0)     # [A, n]: all of 1..k failed
    attempts = (1 + torch.sum(cumfail[:-1], dim=0)).to(torch.int32)
    delivered = cumfail[-1] < 0.5
    return attempts, delivered


def expected_attempts(p_out: Tensor) -> Tensor:
    """[n] expected transmission count ``1 / (1 - p_out)``, with ``p_out``
    capped at ``PRICE_P_CAP`` — the ``price_outage`` comm-energy
    factor."""
    p = torch.clamp(p_out, 0.0, PRICE_P_CAP)
    return 1.0 / (1.0 - p)


def attempt_time(attempts: Tensor, t_comm: Tensor, backoff_s: float) -> Tensor:
    """[n] airtime + backoff of ``attempts`` transmissions (one backoff
    slot before each retransmission)."""
    a = attempts.to(torch.float32)
    return a * t_comm + (a - 1.0) * _f32(backoff_s, a)


def attempt_energy(attempts: Tensor, t_comm: Tensor, P: Tensor) -> Tensor:
    """[n] transmit energy of ``attempts`` transmissions (``P`` on air
    only; backoff slots are idle)."""
    return attempts.to(torch.float32) * P * t_comm
