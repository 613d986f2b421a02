"""Golden-section search (Kiefer, 1953): batched, fixed-iteration.

The paper (Sec. V-C) uses it for the per-device bandwidth subproblem
``min_B phi(gamma, B)``, which is unimodal in B. The fixed iteration count
keeps it one elementwise program over a broadcast bracket; after ``n``
iterations the bracket shrinks by 0.618**n. The port of
``repro.core.gss``: the reference oracle that the Newton best response
is held against (``bw_solver="gss"``). It is plain PyTorch on any device —
the reference computes it outside any Pallas kernel too.
"""
from __future__ import annotations

from typing import Callable

import torch

INVPHI = 0.6180339887498949   # 1/phi
INVPHI2 = 0.3819660112501051  # 1/phi^2


def golden_section_minimize(f: Callable, lo, hi, *, iters: int = 60):
    """Minimize scalar-unimodal ``f`` elementwise over broadcast bounds.

    ``f`` maps a tensor of the bracket's shape to one of the same shape.
    Returns ``(x_min, f_min)``: the better of the final bracket's two
    interior probes, whose values are already in hand. Float32, the
    reference's dtype without x64.

    After ~35 steps the bracket spans a few floats of a flat minimum, so
    where it ends follows the last-bit rounding of ``f``: against the
    reference (whose XLA:CPU code fuses products and sums into FMAs) the
    minimum's value agrees to float32 noise, its location to ~1e-3
    (ROADMAP C-18)."""
    lo = torch.as_tensor(lo, dtype=torch.float32)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=lo.device)
    shape = torch.broadcast_shapes(lo.shape, hi.shape)
    a, b = lo.expand(shape), hi.expand(shape)
    c = a + INVPHI2 * (b - a)
    d = a + INVPHI * (b - a)
    fc, fd = f(c), f(d)
    for _ in range(iters):
        # shrink toward the smaller probe; both probes are evaluated, as
        # the reference's select does
        left = fc < fd
        new_b = torch.where(left, d, b)
        new_a = torch.where(left, a, c)
        new_d = torch.where(left, c, new_a + INVPHI * (new_b - new_a))
        new_c = torch.where(left, new_a + INVPHI2 * (new_b - new_a), d)
        new_fc = torch.where(left, f(new_c), fd)
        new_fd = torch.where(left, fc, f(new_d))
        a, b, c, d, fc, fd = new_a, new_b, new_c, new_d, new_fc, new_fd
    take_c = fc <= fd
    return torch.where(take_c, c, d), torch.where(take_c, fc, fd)
