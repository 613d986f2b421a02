"""Controller API: observation type, context, and the registry.

A *controller* is the per-round decision maker of the FL system: given a
``RoundObservation`` (update norms, channel gains, transmit powers, round
index, PRNG key) it returns a ``RoundDecision`` (selection x, sparsity
gamma, bandwidth B, per-client energy) plus its carried state:

    init(n_clients) -> state
    decide(obs: RoundObservation, state) -> (RoundDecision, state)

Randomness comes from ``obs.key`` (a ``repro_torch.random`` key), never
from a host generator, so a round is pure in (seed, round). Controllers
register under a name with ``@register_controller("name")`` and are built
from a ``ControllerContext`` — the static per-run constants shared by
every strategy. Only ``fairenergy`` is ported so far; the baselines wait
(ROADMAP A-7).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Protocol, runtime_checkable

import torch

from ...devices import resolve_device
from ..channel import comm_energy
from ..fairenergy import RoundDecision

Tensor = torch.Tensor

__all__ = ["Controller", "ControllerContext", "RoundDecision",
           "RoundObservation", "available_controllers", "make_controller",
           "masked_decision", "register_controller", "topk_mask"]


class RoundObservation(NamedTuple):
    """Everything a controller may look at in round r."""
    u_norms: Tensor   # [N] — ||u_i^r||_2 reported by each client
    h: Tensor         # [N] — instantaneous channel gains h_i^r
    P: Tensor         # [N] — transmit powers P_i
    round: int        # round index r
    key: Tensor       # PRNG key for this round (stochastic controllers)
    alive: Any = None  # [N] bool — battery not depleted and, on timed
    #                    rounds, deadline-feasible (None = all alive)
    t_round: Any = None  # [N] f32 — best-case round time (comp + minimum-
    #                      payload comm at full bandwidth), seconds; set
    #                      only on timed rounds (core.rounds)
    e_cmp: Any = None  # [N] f32 — per-round computation energy of THESE
    #                    lanes, set by the sampled decide path
    #                    (core.hierarchy), whose [K_pool] slice no longer
    #                    matches ctx.e_cmp_array(); None = the context's
    e_scale: Any = None  # [N] f32 — comm-energy pricing factor >= 1, the
    #                      expected attempt count 1/(1 - p_out) set by the
    #                      link model in price_outage mode (None = lossless
    #                      pricing, the legacy path)


@dataclasses.dataclass(frozen=True)
class ControllerContext:
    """Static per-run constants controllers are constructed from.

    ``fe_cfg`` is the FairEnergy hyper-parameter dataclass;
    ``fixed_k``/``eco_gamma``/``eco_bandwidth`` parameterize the paper's
    fixed-K baselines and ``tilt_t``/``tilt_ema`` the tilted one; ``e_cmp``
    the per-client per-round computation energy as a length-N tuple
    (None: the communication-only energy model); ``device`` the device the
    controller's state lives on: ``None`` means the GPU and raises when
    none is visible (pass ``device="cpu"`` for the CPU)."""
    n_clients: int
    b_tot: float                       # total uplink bandwidth B_tot (Hz)
    s_bits: float                      # full-precision payload S (bits)
    i_bits: float                      # index/mask overhead I (bits)
    n0: float                          # noise density N0 (W/Hz)
    fe_cfg: Any = None
    fixed_k: Optional[int] = None
    eco_gamma: float = 0.1
    eco_bandwidth: Optional[float] = None
    e_cmp: Optional[tuple] = None      # [N] J/round computation energy
    tilt_t: float = 2.0                # tilted baseline: tilt temperature
    tilt_ema: float = 0.5              # tilted baseline: score EMA step
    device: Any = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))
        # shannon_rate clamps bandwidth to a 1 Hz floor: a bracket whose
        # lower end b_min_frac * B_tot probes below it would price rates
        # at another B than it charges for, so such configs are rejected
        if self.fe_cfg is not None:
            b_min = getattr(self.fe_cfg, "b_min_frac", None)
            if b_min is not None and b_min * self.b_tot < 1.0:
                raise ValueError(
                    f"b_min_frac * b_tot = {b_min * self.b_tot:.3g} Hz is "
                    f"below the 1 Hz rate floor of shannon_rate; raise "
                    f"b_min_frac (>= {1.0 / self.b_tot:.3g}) or b_tot")
        if self.e_cmp is not None:
            object.__setattr__(self, "e_cmp", tuple(float(v)
                                                    for v in self.e_cmp))
            if len(self.e_cmp) != self.n_clients:
                raise ValueError(
                    f"e_cmp has {len(self.e_cmp)} entries for "
                    f"{self.n_clients} clients")

    def e_cmp_array(self) -> Tensor:
        """[N] f32 computation energy (zeros without a device profile)."""
        if self.e_cmp is None:
            return torch.zeros(self.n_clients, dtype=torch.float32,
                               device=self.device)
        return torch.tensor(self.e_cmp, dtype=torch.float32,
                            device=self.device)

    @property
    def k(self) -> int:
        """Baseline selection size K (paper: the mean FairEnergy count)."""
        return self.fixed_k if self.fixed_k is not None else max(1, self.n_clients // 5)

    @property
    def eco_bw(self) -> float:
        """EcoRandom's per-client bandwidth. An ``is None`` check, so an
        explicit 0.0 is honoured; the default splits B_tot over ``k``."""
        if self.eco_bandwidth is not None:
            return self.eco_bandwidth
        return self.b_tot / max(self.k, 1)


@runtime_checkable
class Controller(Protocol):
    """Structural type every strategy implements."""

    def init(self, n_clients: int) -> Any: ...

    def decide(self, obs: RoundObservation, state: Any) -> tuple[RoundDecision, Any]: ...


_REGISTRY: dict[str, Callable[[ControllerContext], Controller]] = {}


def register_controller(name: str):
    """Class decorator: ``@register_controller("fairenergy")``. The class
    must be constructible as ``cls(ctx: ControllerContext)``."""

    def deco(cls):
        if name in _REGISTRY:
            raise ValueError(f"controller {name!r} already registered")
        _REGISTRY[name] = cls
        cls.name = name
        return cls

    return deco


def available_controllers() -> list[str]:
    return sorted(_REGISTRY)


def make_controller(spec: "str | Controller", ctx: ControllerContext) -> Controller:
    """Resolve a registry name or pass through a ready instance."""
    if isinstance(spec, str):
        try:
            cls = _REGISTRY[spec]
        except KeyError:
            raise KeyError(f"unknown controller {spec!r}; available: "
                           f"{available_controllers()}") from None
        return cls(ctx)
    if not isinstance(spec, Controller):
        raise TypeError(f"controller must be a registry name or implement "
                        f"init/decide, got {type(spec).__name__}")
    return spec


# ------------------------------------------------------------ helpers ----
def topk_mask(scores: Tensor, k: int) -> Tensor:
    """Boolean mask of the k largest entries; ties go to the lower index
    and NaN ranks last (``np.argsort(-scores)[:k]``, ``jnp.argsort``'s
    order: a stable sort of ``-scores``, NaN after every number)."""
    n = scores.shape[0]
    order = torch.argsort(-scores, stable=True)     # NaN sorts last
    ranks = torch.empty(n, dtype=torch.int64, device=scores.device)
    ranks[order] = torch.arange(n, device=scores.device)
    return ranks < k


def masked_decision(x: Tensor, gamma: Tensor, bandwidth: Tensor,
                    obs: RoundObservation, ctx: ControllerContext) -> RoundDecision:
    """A ``RoundDecision`` from raw (x, gamma, B): selected clients are
    charged E_i = P_i (gamma_i S + I) / R_i(B_i) + E_cmp,i; gamma, B and E
    are zero elsewhere. Unselected rows are priced at B_tot before the
    mask: ``comm_energy`` is inf below the 1 Hz floor, and ``inf * 0``
    would be NaN. The computation energy is ``obs.e_cmp`` when set (the
    sampled path's ``[K_pool]`` slice), else the context's ``[N]``."""
    xf = x.to(torch.float32)
    e_cmp = obs.e_cmp if obs.e_cmp is not None else ctx.e_cmp_array()
    b_safe = torch.where(x, bandwidth, ctx.b_tot)
    energy = xf * (comm_energy(gamma, b_safe, obs.P, obs.h, ctx.s_bits,
                               ctx.i_bits, ctx.n0) + e_cmp)
    bandwidth = bandwidth * xf
    return RoundDecision(x=x, gamma=gamma * xf, bandwidth=bandwidth,
                         energy=energy,
                         lam=torch.zeros((), dtype=torch.float32,
                                         device=x.device),
                         mu=torch.zeros_like(xf),
                         n_inner=torch.zeros((), dtype=torch.int32,
                                             device=x.device),
                         bw_used=torch.sum(bandwidth))
