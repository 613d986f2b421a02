"""Staleness-weighted buffered aggregation (FedAsync-style).

The port's copy of ``repro.core.rounds.staleness``. A client that misses
the round deadline keeps transmitting in the background. Its sparsified
update sits in ``AsyncState`` — a per-client one-slot buffer carried from
round to round — until the simulated wall-clock has advanced past its
remaining transmission time, then folds into that round's weighted
aggregate with the polynomial staleness discount ``w(tau) = 1 / (1 +
tau)^a`` (Xie et al., FedAsync, arXiv:1903.03934). One slot per client: a
newer late update from the same client overwrites the older one.

Under a clients mesh each rank holds the buffer rows of its own clients,
like the ``[N, D]`` update buffers, so no rank ever holds the full stale
matrix.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...devices import resolve_device

Tensor = torch.Tensor

#: age value marking an empty buffer slot
EMPTY_AGE = -1


class AsyncState(NamedTuple):
    """Carried stale-update buffer ([n] = this rank's padded rows).

    buf:   [n, D] sparsified late updates (zeros where empty)
    age:   [n] int32 rounds since the update was computed; -1 = empty
    t_rem: [n] f32 remaining background-transmission seconds
    """
    buf: Tensor
    age: Tensor
    t_rem: Tensor


def init_async_state(n: int, d: int, device=None) -> AsyncState:
    """Empty buffer for ``n`` (padded) clients and flat dimension ``d``, on
    ``device`` (None: the GPU)."""
    device = resolve_device(device)
    return AsyncState(
        buf=torch.zeros((n, d), dtype=torch.float32, device=device),
        age=torch.full((n,), EMPTY_AGE, dtype=torch.int32, device=device),
        t_rem=torch.zeros((n,), dtype=torch.float32, device=device))


def staleness_weight(age: Tensor, a: float) -> Tensor:
    """w(tau) = 1/(1+tau)^a in (0, 1]: 1 at tau=0, decaying with age; a=0
    disables the discount. ``age`` is clipped at 0 so the -1 empty-slot
    sentinel cannot inflate the weight. The exponent is the float32
    ``-a`` and the power is taken in float64, then rounded once to float32:
    the reference's float32 power, bit for bit."""
    tau = torch.clamp(age, min=0).to(torch.float64)
    exponent = float(torch.tensor(-a, dtype=torch.float32))
    return torch.pow(1.0 + tau, exponent).to(torch.float32)
