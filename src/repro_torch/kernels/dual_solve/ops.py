"""Wrapper of the dual-solve best-response kernel (``csrc/dual_solve.cu``).

``dual_solve`` has ``ref.dual_solve_ref``'s contract: per-client
``(gamma*, b*, e*, phi*)`` at bandwidth price ``lam``. CPU tensors run the
plain version; CUDA tensors launch the kernel on the current stream (one
thread per client, no padding), with the 7 scalars packed into a device
float32 vector so the dual price never leaves the card for a launch.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, check_cuda, is_cpu
from .ref import dual_solve_ref

MAX_GRID = 16


def dual_solve(P, h, u_norms, lam, *, gamma_grid, eta, b_tot, s_bits, i_bits,
               n0, b_lo, newton_iters: int = 3, e_cmp=None):
    if e_cmp is None:
        e_cmp = torch.zeros_like(P)
    if is_cpu(P):
        return dual_solve_ref(P, h, u_norms, lam, gamma_grid=gamma_grid,
                              eta=eta, b_tot=b_tot, s_bits=s_bits,
                              i_bits=i_bits, n0=n0, b_lo=b_lo,
                              newton_iters=newton_iters, e_cmp=e_cmp)
    dev = P.device
    n = P.shape[0]
    for name, t in (("P", P), ("h", h), ("u_norms", u_norms),
                    ("e_cmp", e_cmp)):
        check_cuda(name, t, dtype=torch.float32, ndim=1, device=dev)
        if t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} clients, P has {n}")
    grid = tuple(float(g) for g in gamma_grid)
    if not 1 <= len(grid) <= MAX_GRID:
        raise ValueError(f"gamma grid has {len(grid)} levels; the kernel "
                         f"takes 1..{MAX_GRID}")
    scalars = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=dev)
                           for v in (lam, eta, b_tot, s_bits, i_bits, n0,
                                     b_lo)])
    outs = [torch.empty(n, dtype=torch.float32, device=dev) for _ in range(4)]
    grid_arr = (ctypes.c_float * len(grid))(*grid)
    err = _build.library().dual_solve_f32(
        P.data_ptr(), h.data_ptr(), u_norms.data_ptr(), e_cmp.data_ptr(),
        scalars.data_ptr(), ctypes.cast(grid_arr, ctypes.c_void_p),
        len(grid), int(newton_iters), n, *(o.data_ptr() for o in outs),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "dual_solve_f32")
    dual_solve.launches += 1
    return tuple(outs)


dual_solve.launches = 0
