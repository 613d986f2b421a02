"""Round timing: feasibility, partial energy, and simulated wall-clock.

The port's copy of ``repro.core.rounds.timing``. Every function works
elementwise on float32 tensors over clients; ``comm_time`` comes from
``core.channel`` and is ``inf`` below the 1 Hz bandwidth floor, so a
zero-bandwidth client is deadline-infeasible by construction.
"""
from __future__ import annotations

import torch

from ..channel import comm_time

Tensor = torch.Tensor


def best_case_round_time(t_cmp: Tensor, P: Tensor, h: Tensor, *, b_tot: float,
                         gamma_floor: float, s_bits: float, i_bits: float,
                         n0: float) -> Tensor:
    """[N] s: each client's *best-case* round time — computation plus the
    minimum-payload (gamma = gamma_floor) transmission at the full
    bandwidth budget. A client whose best case already exceeds the
    deadline cannot make the round under any allocation, so the trainer
    feeds ``t <= deadline`` into the observation's hard ``alive`` mask."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=P.device)  # noqa: E731
    return t_cmp + comm_time(f32(gamma_floor), f32(b_tot), P, h, s_bits,
                             i_bits, n0)


def partial_round_energy(t_cmp: Tensor, t_comm: Tensor, e_cmp: Tensor,
                         P: Tensor, deadline) -> Tensor:
    """[N] J spent by round close at ``deadline`` (a float or an [N]
    tensor): computation first (prorated if the deadline lands
    mid-compute), then transmission at power P for whatever remains of the
    window. Equals the full round energy ``e_cmp + P * t_comm`` once
    ``deadline >= t_cmp + t_comm``; instantaneous computation (t_cmp = 0)
    counts as completed."""
    # a float32 tensor: a Python float over a tensor would be computed as
    # its reciprocal times the float, rounded twice
    deadline = torch.as_tensor(deadline, dtype=torch.float32,
                               device=t_cmp.device)
    cmp_frac = torch.where(
        t_cmp > 0.0,
        torch.clamp(deadline / torch.clamp(t_cmp, min=1e-30), 0.0, 1.0), 1.0)
    # clip(deadline - t_cmp, 0, t_comm): an infinite t_comm (sub-floor
    # bandwidth) clips to the finite window, so the product stays defined
    t_tx = torch.minimum(torch.clamp(deadline - t_cmp, min=0.0), t_comm)
    return e_cmp * cmp_frac + P * t_tx


def round_wall_clock(x: Tensor, t_total: Tensor, deadline: float) -> Tensor:
    """0-d float32 s: the simulated duration of a round — the slowest
    selected client's comp+comm, capped at the deadline (the server closes
    the round there regardless). 0.0 when nobody is selected."""
    slowest = torch.max(torch.where(x, t_total, 0.0))
    return torch.clamp(slowest, max=deadline).to(torch.float32)
