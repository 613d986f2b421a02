"""Contribution score and long-term fairness metric (paper Sec. III)."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def contribution_score(update_norm: Tensor, gamma: Tensor) -> Tensor:
    """s_i^r(gamma) = ||u_i^r||_2 * gamma_i^r  (eq. in Sec. III-A)."""
    return update_norm * gamma


def ema_update(q_prev: Tensor, x: Tensor, rho) -> Tensor:
    """q_i^r = rho q_i^{r-1} + (1 - rho) x_i^r  (eq. 1)."""
    return rho * q_prev + (1.0 - rho) * x


def fairness_violation(q: Tensor, pi_min) -> Tensor:
    """Positive where the participation constraint q_i >= pi_min is violated."""
    return torch.clamp(pi_min - q, min=0.0)
