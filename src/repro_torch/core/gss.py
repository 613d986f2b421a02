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

from ..xla_math import fma_f32

INVPHI = 0.6180339887498949   # 1/phi
INVPHI2 = 0.3819660112501051  # 1/phi^2


def golden_section_minimize(f: Callable, lo, hi, *, iters: int = 60):
    """Minimize scalar-unimodal ``f`` elementwise over broadcast bounds.

    ``f`` maps a tensor of the bracket's shape to one of the same shape.
    Returns ``(x_min, f_min)``: the better of the final bracket's two
    interior probes, whose values are already in hand. Float32, the
    reference's dtype without x64.

    After ~35 steps the bracket spans a few floats of a flat minimum, so
    where it ends follows the last-bit rounding of ``f`` and of the probes.
    Each probe ``a + k (b - a)`` is one FMA, as the reference's XLA:CPU
    code computes it inside the solver; with ``f`` computed the same way
    (``core.fairenergy.best_response_gss``) the search ends where the
    reference's does (ROADMAP C-18)."""
    lo = torch.as_tensor(lo, dtype=torch.float32)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=lo.device)
    shape = torch.broadcast_shapes(lo.shape, hi.shape)
    a, b = lo.expand(shape), hi.expand(shape)
    f1 = torch.tensor(INVPHI, dtype=torch.float32, device=lo.device)
    f2 = torch.tensor(INVPHI2, dtype=torch.float32, device=lo.device)
    lin = lambda x, k, y: fma_f32(k, y - x, x).to(x.device)  # noqa: E731
    c = lin(a, f2, b)
    d = lin(a, f1, b)
    fc, fd = f(c), f(d)
    for _ in range(iters):
        # shrink toward the smaller probe; both probes are evaluated, as
        # the reference's select does
        left = fc < fd
        new_b = torch.where(left, d, b)
        new_a = torch.where(left, a, c)
        new_d = torch.where(left, c, lin(new_a, f1, new_b))
        new_c = torch.where(left, lin(new_a, f2, new_b), d)
        new_fc = torch.where(left, f(new_c), fd)
        new_fd = torch.where(left, fc, f(new_d))
        a, b, c, d, fc, fd = new_a, new_b, new_c, new_d, new_fc, new_fd
    take_c = fc <= fd
    return torch.where(take_c, c, d), torch.where(take_c, fc, fd)
