"""Counter-based threefry2x32 PRNG with ``jax.random``'s key semantics.

The port's explicit generator. Like the JAX package's randomness it is
pure in (seed, stream, round): a key is a ``[..., 2]`` int64 tensor of two
32-bit words, ``fold_in`` and ``split`` derive new keys by hashing, and
every draw is a hash of a counter under a key. The functions reproduce
``jax.random`` bit for bit under ``jax.threefry_partitionable(False)``
(the semantics the JAX package's goldens were recorded with). The float
transforms of the uniforms (``exponential``, ``gumbel``, ``normal``,
``truncated_normal``) use
XLA:CPU's float32 ``log``, ``log1p`` and ``erf_inv`` (``xla_math``), so
they are bit-equal to the JAX package's CPU draws too:

* ``PRNGKey(seed) = [0, seed]`` for an int32 seed;
* ``fold_in(key, d) = threefry(key, [0, d])``;
* ``split(key, n)`` hashes the counters ``0 .. 2n-1`` and reshapes to
  ``[n, 2]``;
* ``random_bits(key, shape)`` hashes ``0 .. size-1`` (odd sizes pad one
  zero counter), split in halves as the two threefry input words.

uint32 arithmetic is emulated on int64 tensors masked to 32 bits, so the
functions run on any device; the trainer keeps its keys on the host,
where these [N]-sized hashes are cheapest. Keys with leading batch
dimensions broadcast (``vmap`` in the JAX package).
"""
from __future__ import annotations

import math

import torch

from .xla_math import SQRT2_F32, erfinv_xla, fma_f32, log1p_xla, log_xla

MASK32 = 0xFFFFFFFF

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 20-round threefry2x32 block function on broadcastable int64
    tensors holding uint32 words (Salmon et al., SC'11; the JAX kernel)."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def _hash_counts(key: torch.Tensor, count: int) -> torch.Tensor:
    """``threefry_2x32(key, iota(count))``: [..., count] words for keys of
    shape [..., 2]. The counters are split in halves (one zero counter
    pads an odd count) and fed as the two input words."""
    n = count + (count % 2)
    iota = torch.arange(n, dtype=torch.int64, device=key.device)
    if count % 2:
        iota[-1] = 0
    half = n // 2
    k0, k1 = key[..., 0:1], key[..., 1:2]
    y0, y1 = threefry2x32(k0, k1, iota[:half], iota[half:])
    return torch.cat([y0, y1], dim=-1)[..., :count]


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """Key for an int32 seed: ``[seed >> 32, seed & 0xFFFFFFFF]`` with the
    high word 0, as ``jax.random.PRNGKey`` builds it without x64."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} does not fit int32")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """Fold a uint32 ``data`` word (an int, or an int tensor broadcasting
    against the key's batch shape) into ``key``."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys, ``[..., num, 2]`` (non-partitionable layout)."""
    words = _hash_counts(key, 2 * num)
    return words.reshape(*key.shape[:-1], num, 2)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """uint32 words (int64 tensor) of ``key.shape[:-1] + shape``."""
    shape = tuple(shape)
    words = _hash_counts(key, math.prod(shape))
    return words.reshape(*key.shape[:-1], *shape)


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms in [minval, maxval): the top 23 bits as a
    mantissa in [1, 2), minus 1 — JAX's construction — scaled and shifted
    in one rounding, as XLA:CPU's FMA does."""
    bits = random_bits(key, shape)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, fma_f32(floats, hi - lo, lo))


def exponential(key: torch.Tensor, shape) -> torch.Tensor:
    """Standard exponential draws ``-log1p(-u)`` (float32), with XLA's
    ``log1p``."""
    return -log1p_xla(-uniform(key, shape))


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """Standard normal float32 draws ``sqrt(2) erf_inv(u)``, u uniform in
    [nextafter(-1, 0), 1) — ``jax.random.normal``'s construction, with
    XLA's ``erf_inv``."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    return erfinv_xla(uniform(key, shape, minval=lo, maxval=1.0)) * SQRT2_F32


# float32 erf(bound / sqrt(2)) as XLA computes it, for the bounds the JAX
# package draws truncated normals between
_ERF_OF_BOUND = {2.0: float(torch.tensor(1064589848, dtype=torch.int32)
                            .view(torch.float32))}


def truncated_normal(key: torch.Tensor, lower: float, upper: float,
                     shape) -> torch.Tensor:
    """float32 normals truncated to (lower, upper), ``jax.random.
    truncated_normal``'s construction: ``sqrt(2) erf_inv(u)``, u uniform
    between the bounds' erf, clipped inside the open interval. The bounds'
    erf is XLA's float32 value, tabulated for the symmetric bound 2 (the
    fan-in initializers'); other bounds raise."""
    if -lower != upper or float(upper) not in _ERF_OF_BOUND:
        raise ValueError(f"truncated_normal takes the bounds -b, b for b in "
                         f"{sorted(_ERF_OF_BOUND)}, got ({lower}, {upper})")
    e = _ERF_OF_BOUND[float(upper)]
    out = erfinv_xla(uniform(key, shape, minval=-e, maxval=e)) * SQRT2_F32
    lo = torch.nextafter(torch.tensor(float(lower)), torch.tensor(float("inf")))
    hi = torch.nextafter(torch.tensor(float(upper)), torch.tensor(float("-inf")))
    return torch.clamp(out, lo.item(), hi.item())


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """int32 draws in [minval, maxval), ``jax.random.randint``'s
    construction: two 32-bit words per value from ``split(key)``, combined
    modulo the span in wrapping uint32 arithmetic."""
    shape = tuple(shape)
    lo32, hi32 = -(1 << 31), (1 << 31) - 1
    minval = max(lo32, min(hi32, int(minval)))
    maxval = max(lo32, min(hi32, int(maxval)))
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = (maxval - minval) & MASK32 if maxval > minval else 1
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & MASK32) % span
    offset = ((higher % span) * multiplier) & MASK32
    offset = ((offset + lower % span) & MASK32) % span
    out = (minval + offset) & MASK32
    return torch.where(out >= (1 << 31), out - (1 << 32), out).to(torch.int32)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """float32 Gumbel draws ``-log(-log(u))``, u uniform in [tiny, 1) —
    ``jax.random.gumbel``'s default ``mode="low"`` — with XLA's ``log``."""
    tiny = float(torch.finfo(torch.float32).tiny)
    return -log_xla(-log_xla(uniform(key, shape, minval=tiny, maxval=1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """One sample per distribution along ``axis``: ``argmax(gumbel +
    logits)`` (the Gumbel-max trick, as ``jax.random.categorical`` with
    replacement). The noise is drawn on the logits' device; every step of
    it is exact float32 arithmetic, so devices agree."""
    noise = gumbel(key.to(logits.device), tuple(logits.shape))
    return torch.argmax(noise + logits.float(), dim=axis)
