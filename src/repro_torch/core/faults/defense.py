"""Defended aggregation: finite screen, streaming norm clip, trimmed mean.

The port's copy of ``repro.core.faults.defense``. The trainer
(``repro_torch.fl.server``) routes its combine step through a registered
*aggregator*: an object mapping this rank's sparse update rows and
participation weights to the weighted-sum pair that the trainer
all-reduces. Two registry entries:

* ``"mean"`` — the legacy |D_i|-weighted mean (``fl.updates.weighted_sum``,
  accumulated in float64 as the trainer always has);
* ``"defended"`` — ``DefenseConfig``-driven robustness on top of the same
  weighted mean: a **finite screen** rejecting rows with any non-finite
  coefficient, **norm clipping** against a streaming EMA of the
  participating update-norm quantile (the scalar tracker rides in the
  carry as ``DefenseState``), and an optional coordinate-wise **trimmed
  mean**.

The clip's row norms are the port's norms kernel
(``kernels.score_norm.row_l2_norms``: one more launch on CUDA tensors).
The trimmed mean sorts each coordinate over the clients with
``torch.sort`` (the reference sorts outside any Pallas kernel too) and
sums the kept window in float64.

Under a clients mesh the screen and clip touch only this rank's rows; the
[n] norms and participation are all-gathered for the (replicated)
quantile, and only the trimmed mean, which needs per-coordinate order
statistics over every client, gathers the full update matrix. With every
knob disabled the defended aggregator equals the legacy weighted mean bit
for bit: the screen passes every finite row untouched and the clip scale
is exactly 1.0.

Clipping uses the *previous* rounds' quantile tracker, so a round's own
outliers can never raise their own threshold; the tracker bootstraps from
the first participating round (no clipping until it has a value).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from ...devices import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DefenseConfig:
    """Knobs of the defended aggregator.

    finite_screen: reject (zero-weight) any update row containing a NaN
        or Inf coefficient.
    clip_q: quantile of the participating update norms the streaming
        tracker follows (0 disables clipping). Default is the median,
        which stays honest up to 50% corruption.
    clip_mult: rows with norm above ``clip_mult * tau`` are rescaled down
        to that limit.
    clip_beta: EMA rate of the quantile tracker (1.0 = no memory). The
        tracker sees norms *through the current clip limit*, so it can rise
        by at most a factor ``clip_mult`` per step.
    trim_frac: coordinate-wise trimmed mean — drop the lowest and highest
        ``trim_frac`` fraction of participating values per coordinate and
        average the rest, *unweighted* (replaces the weighted mean when >
        0). Under a mesh this all-gathers the sparse update matrix.
    """
    finite_screen: bool = True
    clip_q: float = 0.5
    clip_mult: float = 4.0
    clip_beta: float = 0.2
    trim_frac: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.clip_q < 1.0:
            raise ValueError(f"clip_q must be in [0, 1), got {self.clip_q}")
        if self.clip_mult <= 0.0:
            raise ValueError(f"clip_mult must be > 0, got {self.clip_mult}")
        if not 0.0 < self.clip_beta <= 1.0:
            raise ValueError(f"clip_beta must be in (0, 1], got "
                             f"{self.clip_beta}")
        if not 0.0 <= self.trim_frac < 0.5:
            raise ValueError(f"trim_frac must be in [0, 0.5), got "
                             f"{self.trim_frac}")

    @property
    def enabled(self) -> bool:
        return self.finite_screen or self.clip_q > 0.0 or self.trim_frac > 0.0


class DefenseState(NamedTuple):
    """Carried defense state: ``tau`` is the streaming EMA of the
    ``clip_q``-quantile of participating update norms (0 = not yet
    bootstrapped — no clipping). Replicated under a mesh."""
    tau: Tensor


def init_defense_state(device=None) -> DefenseState:
    """The unbootstrapped tracker, on ``device`` (None: the GPU)."""
    device = resolve_device(device)
    return DefenseState(tau=torch.zeros((), dtype=torch.float32,
                                        device=device))


def _masked_quantile(vals: Tensor, mask: Tensor, q: float) -> Tensor:
    """q-quantile of ``vals[mask]`` with a device mask: sort with +inf
    sentinels and index at ``floor(q * (m - 1))``. 0.0 when the mask is
    empty. No host synchronization."""
    s = torch.sort(torch.where(mask, vals, torch.inf)).values
    m = torch.sum(mask.to(torch.int32))
    pos = torch.floor(torch.tensor(q, dtype=torch.float32, device=vals.device)
                      * (m - 1).to(torch.float32)).to(torch.int64)
    idx = torch.minimum(torch.clamp(pos, min=0), torch.clamp(m - 1, min=0))
    return torch.where(m > 0, s.gather(0, idx.reshape(1))[0], 0.0)


# --------------------------------------------------------- registry ----
_AGGREGATORS: dict[str, type] = {}


def register_aggregator(name: str):
    """Class decorator: ``@register_aggregator("defended")``. The class
    must be constructible as ``cls(cfg)`` (cfg may be None)."""

    def deco(cls):
        if name in _AGGREGATORS:
            raise ValueError(f"aggregator {name!r} already registered")
        _AGGREGATORS[name] = cls
        cls.name = name
        return cls

    return deco


def available_aggregators() -> list[str]:
    return sorted(_AGGREGATORS)


def make_aggregator(spec, cfg=None):
    """Resolve a registry name (building ``cls(cfg)``) or pass through a
    ready instance (anything callable with an ``init`` method)."""
    if isinstance(spec, str):
        try:
            cls = _AGGREGATORS[spec]
        except KeyError:
            raise KeyError(f"unknown aggregator {spec!r}; available: "
                           f"{available_aggregators()}") from None
        return cls(cfg)
    if not (callable(spec) and hasattr(spec, "init")):
        raise TypeError("aggregator must be a registry name or provide "
                        f"init/__call__, got {type(spec).__name__}")
    return spec


# The aggregator protocol: ``agg(sparse [n_local, D], part_f [n_local] 0/1
# participation, w_data [n_local] data weights, state, gather=None,
# n_shards=1) -> (partial [D] float64, wsum 0-d float64, state', stats,
# cleaned_sparse)``. ``gather`` maps this rank's [n_local, ...] rows to
# every rank's, in rank order (None without a mesh); ``partial``/``wsum``
# are the pair the trainer all-reduces; ``cleaned_sparse`` is the
# screened and clipped matrix (what the staleness buffer must hold);
# ``stats`` holds this rank's int32 counts (``n_rejected``,
# ``n_clipped``), which the trainer all-reduces.
Gather = Optional[Callable[[Tensor], Tensor]]


@register_aggregator("mean")
class MeanAggregator:
    """The legacy |D_i|-weighted mean."""

    enabled = False

    def __init__(self, cfg=None):
        del cfg

    def init(self, device=None):
        return None

    def __call__(self, sparse, part_f, w_data, state, *, gather: Gather = None,
                 n_shards: int = 1):
        from ...fl.updates import weighted_sum
        w = part_f * w_data
        return weighted_sum(w, sparse), torch.sum(w.double()), state, {}, sparse


@register_aggregator("defended")
class DefendedAggregator:
    """Screen -> clip -> (weighted or trimmed) combine, on this rank's rows
    (the aggregator protocol above)."""

    def __init__(self, cfg: DefenseConfig):
        if cfg is None:
            cfg = DefenseConfig()
        self.cfg = cfg

    @property
    def enabled(self) -> bool:
        return self.cfg.enabled

    def init(self, device=None):
        return init_defense_state(device) if self.cfg.clip_q > 0.0 else None

    def __call__(self, sparse, part_f, w_data, state, *, gather: Gather = None,
                 n_shards: int = 1):
        from ...fl.updates import finite_rows, weighted_sum
        from ...kernels.score_norm.ops import row_l2_norms
        cfg = self.cfg
        dev = sparse.device
        part = part_f > 0.0
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        n_rej = zero
        if cfg.finite_screen:
            ok = finite_rows(sparse)
            n_rej = torch.sum((part & ~ok).to(torch.int32))
            part = part & ok
            part_f = part_f * ok.to(torch.float32)
            # zero the rejected rows: a 0-weight NaN row would still
            # poison the weighted sum (0 * nan = nan)
            sparse = torch.where(ok[:, None], sparse, 0.0)
        n_clip = zero
        if cfg.clip_q > 0.0:
            norms = row_l2_norms(sparse)
            if gather is not None:
                norms_g = gather(norms)
                part_g = gather(part.to(torch.float32)) > 0.0
            else:
                norms_g, part_g = norms, part
            tau = state.tau
            # clip against the PREVIOUS tau; tau == 0 (not bootstrapped)
            # is an infinite limit — no clipping yet
            limit = cfg.clip_mult * torch.where(tau > 0.0, tau, torch.inf)
            # the quantile sees only finite, nonzero participating norms
            # (a screen-less run can carry NaN norms), through the limit
            okq = part_g & torch.isfinite(norms_g) & (norms_g > 0.0)
            qn = _masked_quantile(torch.minimum(norms_g, limit), okq,
                                  cfg.clip_q)
            tau_new = torch.where(
                torch.any(okq),
                torch.where(tau > 0.0,
                            (1.0 - cfg.clip_beta) * tau + cfg.clip_beta * qn,
                            qn),
                tau)
            # minimum and maximum keep a NaN norm's NaN, as the reference's
            scale = torch.minimum(torch.ones_like(norms),
                                  limit / torch.maximum(
                                      norms, torch.full_like(norms, 1e-30)))
            scale = torch.where(part & torch.isfinite(scale), scale, 1.0)
            n_clip = torch.sum((part & (scale < 1.0)).to(torch.int32))
            sparse = sparse * scale[:, None]
            state = DefenseState(tau=tau_new)
        stats = {"n_rejected": n_rej, "n_clipped": n_clip}
        if cfg.trim_frac > 0.0:
            if gather is not None:
                sp_g = gather(sparse)
                pt_g = gather(part.to(torch.float32)) > 0.0
            else:
                sp_g, pt_g = sparse, part
            # per-coordinate sort with +inf sentinels on non-participating
            # rows: the m participating values take ranks [0, m) and the
            # kept window [lo, m - lo) never touches a sentinel
            vals = torch.where(pt_g[:, None], sp_g, torch.inf)
            srt = torch.sort(vals, dim=0).values
            del vals
            m = torch.sum(pt_g.to(torch.int32))
            lo = torch.floor(torch.tensor(cfg.trim_frac, dtype=torch.float32,
                                          device=dev)
                             * m.to(torch.float32)).to(torch.int32)
            hi = m - lo
            idx = torch.arange(srt.shape[0], dtype=torch.int32, device=dev)
            keep = (idx >= lo) & (idx < hi)
            # the kept window's sum in float64, one row at a time: the
            # same sum on every device and every rank
            kept = torch.zeros(srt.shape[1], dtype=torch.float64, device=dev)
            for i in range(srt.shape[0]):
                kept += torch.where(keep[i], srt[i], 0.0).double()
            del srt
            cnt = torch.clamp(hi - lo, min=1).to(torch.float32)
            mean = (kept / cnt.double()).to(torch.float32)
            # every rank computes the same replicated trimmed mean; divide
            # by the rank count so the trainer's all-reduced pair still
            # reduces to exactly that mean
            inv = 1.0 / max(int(n_shards), 1)
            partial = torch.where(m > 0, mean, 0.0).double() * inv
            wsum = torch.where(m > 0, 1.0, 0.0).to(torch.float64) * inv
            return partial, wsum, state, stats, sparse
        w = part_f * w_data
        return (weighted_sum(w, sparse), torch.sum(w.double()), state, stats,
                sparse)
