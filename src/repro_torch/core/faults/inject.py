"""(seed, round)-pure fault draws: crashes, corruption, channel error, churn.

The port's copy of ``repro.core.faults.inject``. Every function folds a
private stream tag and then the round index into the trainer's fault key
before drawing (``repro_torch.random``, bit-equal to ``jax.random``), so
the injected faults are a pure function of (seed, round) and equal to the
reference's: resuming from a checkpoint or running on a clients mesh
injects the identical faults. The draws are made over the full ``[n]``
client vector on the host; the corruption of the ``[n_local, D]`` payload
is then applied to each rank's rows.
"""
from __future__ import annotations

import torch

from ... import random as prng
from ...xla_math import exp_xla

Tensor = torch.Tensor

_CRASH_STREAM = 1
_CORRUPT_STREAM = 2
_CHEST_STREAM = 3
_CHURN_STREAM = 4
_PHASE_STREAM = 5


def _stream_key(key: Tensor, stream: int, round_idx: int) -> Tensor:
    return prng.fold_in(prng.fold_in(key, stream), round_idx)


def crash_draw(key: Tensor, round_idx: int, n: int, rate: float
               ) -> tuple[Tensor, Tensor]:
    """Mid-round crash draw: ([n] bool crash mask, [n] f32 crash point).
    The crash point is the uniform fraction of the client's own round
    (comp + comm) at which it dies."""
    u = prng.uniform(_stream_key(key, _CRASH_STREAM, round_idx), (2, n))
    return u[0] < rate, u[1]


def corrupt_draw(key: Tensor, round_idx: int, n: int, rate: float
                 ) -> tuple[Tensor, Tensor]:
    """Payload-corruption draw: ([n] bool mask, [n] f32 flavor uniform).
    The flavor picks the corruption kind in ``"mixed"`` mode."""
    u = prng.uniform(_stream_key(key, _CORRUPT_STREAM, round_idx), (2, n))
    return u[0] < rate, u[1]


def corrupt_payload(updates: Tensor, mask: Tensor, flavor: Tensor, mode: str,
                    scale: float) -> Tensor:
    """Corrupt the masked rows of an ``[n, D]`` update matrix.

    ``"nan"`` / ``"inf"`` poison every coefficient of the row, ``"scale"``
    multiplies it by ``-scale`` (a sign-flipped outlier that passes the
    finite screen and must be caught by norm clipping), ``"mixed"`` draws
    one of the three per row from ``flavor`` (below 1/3 NaN, below 2/3
    Inf, else scaled). Unmasked rows pass through bit for bit."""
    m = mask[:, None]
    if mode == "nan":
        return torch.where(m, float("nan"), updates)
    if mode == "inf":
        return torch.where(m, float("inf"), updates)
    if mode == "scale":
        return torch.where(m, updates * -float(scale), updates)
    f = flavor[:, None]
    poisoned = torch.where(f < (1.0 / 3.0), float("nan"),
                           torch.where(f < (2.0 / 3.0), float("inf"),
                                       updates * -float(scale)))
    return torch.where(m, poisoned, updates)


def channel_estimate(key: Tensor, round_idx: int, h: Tensor, sigma: float
                     ) -> Tensor:
    """The controller's noisy view of the channel: ``h * exp(sigma * eps)``
    with ``eps ~ N(0, 1)`` per client — multiplicative lognormal error.
    The float32 ``exp`` is XLA's (``xla_math.exp_xla``), so ``h_est`` is
    bit-equal to the JAX package's."""
    eps = prng.normal(_stream_key(key, _CHEST_STREAM, round_idx),
                      tuple(h.shape)).to(h.device)
    return h * exp_xla(float(sigma) * eps)


def presence_mask(key: Tensor, round_idx: int, n: int, away: float, dwell: int
                  ) -> Tensor:
    """[n] bool — which clients are present in round ``round_idx``.

    Client i redraws a Bernoulli(1 - away) presence once per
    ``dwell``-round epoch, with a per-client random phase; pure in (key,
    round), so any round's presence can be recomputed without history."""
    if dwell <= 0:                       # churn disabled: closed population
        return torch.ones(n, dtype=torch.bool)
    phase = prng.randint(prng.fold_in(key, _PHASE_STREAM), (n,), 0, dwell)
    epoch = (int(round_idx) + phase.to(torch.int64)) // dwell
    base = prng.fold_in(key, _CHURN_STREAM)
    keys = prng.fold_in(prng.fold_in(base, epoch),
                        torch.arange(n, dtype=torch.int64))
    u = prng.uniform(keys, ())
    return u >= torch.tensor(away, dtype=torch.float32)


def arrival_mask(key: Tensor, round_idx: int, n: int, away: float, dwell: int
                 ) -> tuple[Tensor, Tensor]:
    """([n] present, [n] arrived-this-round). An arrival is a presence
    edge — present now, absent last round; round 0 has no edges."""
    cur = presence_mask(key, round_idx, n, away, dwell)
    prev = presence_mask(key, max(int(round_idx) - 1, 0), n, away, dwell)
    arrived = cur & ~prev & (int(round_idx) > 0)
    return cur, arrived
