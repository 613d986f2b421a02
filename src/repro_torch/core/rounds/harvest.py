"""Energy harvesting: (seed, round)-pure battery recharge between rounds.

The port's copy of ``repro.core.rounds.harvest``. Each round, client i
harvests ``rate_i * Exp(1)`` Joules — an exponential draw whose
per-client mean ``rate_i`` scales with the device tier: ``harvest_rates``
apportions the fleet-mean ``harvest_j`` proportionally to CPU frequency.
The draw folds the round index into the trainer's harvest stream
(``repro_torch.random``, bit-equal to ``jax.random``'s draws), so resuming
or re-running a round harvests the identical energy.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ... import random as prng
from ...devices import resolve_device

Tensor = torch.Tensor


def harvest_rates(profile, n: int, mean_j: float, device=None) -> Tensor:
    """[n] f32 per-client mean harvest (J/round), fleet mean ``mean_j``.

    With a ``DeviceProfile`` the means are proportional to CPU frequency
    (in float64 on the host, then float32); without one the fleet is
    homogeneous. On ``device`` (None: the GPU)."""
    device = resolve_device(device)
    if profile is None:
        return torch.full((n,), mean_j, dtype=torch.float32, device=device)
    freq = np.asarray(profile.freq.cpu().numpy(), np.float64)
    return torch.as_tensor((mean_j * freq / freq.mean()).astype(np.float32),
                           device=device)


def harvest_draw(key: Tensor, round_idx: int, rates: Tensor) -> Tensor:
    """[n] J harvested after round ``round_idx`` — pure in (key, round):
    ``fold_in`` then an exponential draw scaled by the per-client mean."""
    rkey = prng.fold_in(key, round_idx)
    return rates * prng.exponential(rkey, tuple(rates.shape)).to(rates.device)


def apply_harvest(battery: Tensor, cap: Tensor, key: Tensor, round_idx: int,
                  rates: Optional[Tensor]) -> Tensor:
    """Recharge ``battery`` by the round's draw, clipped at capacity
    ``cap`` (inf-capacity clients stay inf). ``rates=None`` is a no-op."""
    if rates is None:
        return battery
    return torch.minimum(battery + harvest_draw(key, round_idx, rates), cap)
