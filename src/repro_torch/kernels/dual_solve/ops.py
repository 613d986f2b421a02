"""Wrapper of the dual-solve best-response kernels (``csrc/dual_solve.cu``).

``dual_solve`` has ``ref.dual_solve_ref``'s contract: per-client
``(gamma*, b*, e*, phi*)`` at bandwidth price ``lam``, plus ``bits*`` on
the joint (gamma, bits) grid. CPU tensors run the plain version; CUDA
tensors launch the kernel on the current stream (one thread per client,
no padding), with the 7 scalars packed into a device float32 vector so
the dual price never leaves the card for a launch, and the per-level
constants folded on the host as the plain version folds them. Grids of
more than ``MAX_LEVELS`` levels are refused on either device.

Launches are counted per variant: ``dual_solve.launches`` (gamma grid),
``.launches_scaled`` (with ``e_scale``), ``.launches_joint`` (with
``bits_grid``) and ``.launches_joint_scaled`` (both).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, check_cuda, is_cpu
from .ref import dual_solve_ref, level_coefficients

MAX_LEVELS = 32

COUNTERS = {(False, False): "launches", (True, False): "launches_scaled",
            (False, True): "launches_joint", (True, True): "launches_joint_scaled"}


def dual_solve(P, h, u_norms, lam, *, gamma_grid, eta, b_tot, s_bits, i_bits,
               n0, b_lo, newton_iters: int = 3, e_cmp=None, e_scale=None,
               bits_grid=None):
    if e_cmp is None:
        e_cmp = torch.zeros_like(P)
    coef = level_coefficients(gamma_grid, bits_grid)
    n_levels = len(coef["gamma"])
    if not 1 <= n_levels <= MAX_LEVELS:
        raise ValueError(f"the grid has {n_levels} levels; the kernel takes "
                         f"1..{MAX_LEVELS}")
    if is_cpu(P):
        return dual_solve_ref(P, h, u_norms, lam, gamma_grid=gamma_grid,
                              eta=eta, b_tot=b_tot, s_bits=s_bits,
                              i_bits=i_bits, n0=n0, b_lo=b_lo,
                              newton_iters=newton_iters, e_cmp=e_cmp,
                              e_scale=e_scale, bits_grid=bits_grid)
    dev = P.device
    n = P.shape[0]
    vectors = [("P", P), ("h", h), ("u_norms", u_norms), ("e_cmp", e_cmp)]
    if e_scale is not None:
        vectors.append(("e_scale", e_scale))
    for name, t in vectors:
        check_cuda(name, t, dtype=torch.float32, ndim=1, device=dev)
        if t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} clients, P has {n}")
    joint = coef["bits"] is not None
    table = (coef["gamma"] + coef["pay"] + coef["score"]
             + (coef["bits"] if joint else [0.0] * n_levels))
    scalars = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=dev)
                           for v in (lam, eta, b_tot, s_bits, i_bits, n0,
                                     b_lo)])
    outs = [torch.empty(n, dtype=torch.float32, device=dev)
            for _ in range(5 if joint else 4)]
    table_arr = (ctypes.c_float * len(table))(*table)
    err = _build.library().dual_solve_levels_f32(
        P.data_ptr(), h.data_ptr(), u_norms.data_ptr(), e_cmp.data_ptr(),
        None if e_scale is None else e_scale.data_ptr(), scalars.data_ptr(),
        ctypes.cast(table_arr, ctypes.c_void_p), n_levels, int(newton_iters),
        n, *(o.data_ptr() for o in outs[:4]),
        outs[4].data_ptr() if joint else None,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "dual_solve_levels_f32")
    attr = COUNTERS[(e_scale is not None, joint)]
    setattr(dual_solve, attr, getattr(dual_solve, attr) + 1)
    return tuple(outs)


for _attr in COUNTERS.values():
    setattr(dual_solve, _attr, 0)
