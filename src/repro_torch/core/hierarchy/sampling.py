"""Deficit-sampled decide: the ``[K_pool]`` candidate-slice control path
(the port of ``repro.core.hierarchy.sampling``).

``SampledController`` wraps any registered controller (FairEnergy's dual
solve or a baseline) behind the same controller protocol. Each round it

1. draws a candidate pool of ``K_pool`` clients: a Gumbel top-k draw
   proportional to the wrapped controller's fairness deficit
   (``sampling_deficit``; uniform for stateless baselines), stratified
   over the k-means clusters, pure in (sampler key, round) through
   ``fold_in``;
2. gathers the observation and every per-client state lane to the
   ``[K_pool]`` slice and runs the wrapped ``decide`` there, so the dual
   solve scales with the pool, not N;
3. scatters the decision (``bits`` included) and the state back.
   Non-candidates are unselected (selection, gamma, bandwidth, energy 0),
   their participation EMA decays as an unselected round's
   (``observe_unsampled``: FairEnergy's ``q <- rho q``) and their fairness
   duals stay frozen.

The pool is computed on the device the controller state lives on: the
segment sums of the cluster stratification are added in index order on
the host (``np.add.at``, as ``jax.ops.segment_sum`` adds them), the
Gumbel noise is drawn by the port's threefry on the weights' device and
the top-k is a stable sort, so the card and the CPU draw the same pools.

``HierarchyState(inner, assign, key)`` keeps the reference's field
names, so checkpoint keys read ``.inner/...``, ``.assign`` and ``.key``.
The sampler base key is constant (per-round keys are ``fold_in(key,
r)``) and stays on the host like the trainer's other keys, so resuming
mid-trajectory replays the same pools.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ... import random as prng
from ...xla_math import log_xla
from ..controllers.base import ControllerContext, RoundObservation
from ..fairenergy import RoundDecision
from .cluster import assign_nearest, cluster_features, kmeans
from .config import HierarchyConfig

Tensor = torch.Tensor


class HierarchyState(NamedTuple):
    """Carried state of the sampled decide path."""
    inner: Any       # the wrapped controller's own state
    assign: Tensor   # [N] int32 cluster ids (re-assigned on churn arrivals)
    key: Tensor      # sampler base key (host) — constant; rounds fold r


def deficit_weights(deficit: Tensor, assign: Tensor, n_clusters: int,
                    floor: float) -> Tensor:
    """[N] sampling weights ``max(deficit, 0) + floor``, stratified so
    each cluster's total mass is proportional to its population. As the
    reference computes it: the cluster sums in index order, and ``count /
    n`` as the product ``count * float32(1 / n)`` that XLA rewrites the
    division into."""
    base = torch.clamp(deficit, min=0.0) + floor
    if n_clusters <= 1:
        return base
    a = assign.cpu().numpy().astype(np.int64)
    seg = np.zeros(n_clusters, np.float32)
    np.add.at(seg, a, base.cpu().numpy())
    cnt = np.bincount(a, minlength=n_clusters).astype(np.float32)
    dev = base.device
    seg_a = torch.from_numpy(seg[a]).to(dev)
    frac = torch.from_numpy(cnt[a] * np.float32(1.0 / base.shape[0])).to(dev)
    return base * frac / torch.clamp(seg_a, min=1e-30)


def pool_indices(key: Tensor, round_idx: int, weights: Tensor,
                 k_pool: int) -> Tensor:
    """[K_pool] int64 candidate indices (ascending) on the weights'
    device: a weighted draw without replacement by Gumbel top-k, the top
    ``K_pool`` of ``log(max(w, 0)) + G`` with ties to the lower index (as
    ``lax.top_k``). Zero-weight clients (log 0 = -inf) enter only when
    fewer than K_pool positive weights exist, in index order."""
    pkey = prng.fold_in(key, round_idx).to(weights.device)
    g = log_xla(torch.clamp(weights, min=0.0)) + prng.gumbel(
        pkey, tuple(weights.shape))
    order = torch.sort(g, descending=True, stable=True).indices[:k_pool]
    return torch.sort(order).values


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of ``tree`` (NamedTuples, tuples,
    lists, dicts; ``None`` stays ``None``), zipped with the same-shaped
    trees ``rest``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*[_tree_map(fn, *vs) for vs in zip(tree, *rest)])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, *vs) for vs in zip(tree, *rest))
    return fn(tree, *rest)


def _per_client(leaf, n: int) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.ndim >= 1 \
        and leaf.shape[0] == n


def _gather_state(tree, idx: Tensor, n: int):
    """Every per-client leaf (leading dimension ``n``) gathered to the
    pool slice; scalars and config leaves (``FEParams``) pass through."""
    return _tree_map(lambda leaf: leaf[idx] if _per_client(leaf, n)
                     else leaf, tree)


def _scatter_state(old, new_pooled, idx: Tensor, n: int):
    """The pooled lanes written back into the full state; the other lanes
    keep their values (``observe_unsampled`` decays them afterwards).
    Scalar leaves take the pool-solved value (the bandwidth price ``lam``
    is global)."""
    return _tree_map(lambda o, p: o.index_copy(0, idx, p)
                     if _per_client(o, n) else p, old, new_pooled)


def _scatter(idx: Tensor, vals: Tensor, n: int) -> Tensor:
    """An [n] zero vector of ``vals``' type with ``vals`` at ``idx``."""
    return torch.zeros(n, dtype=vals.dtype, device=vals.device).index_copy(
        0, idx, vals)


class SampledController:
    """Controller-protocol wrapper running the sampled decide path;
    ``decide`` takes and returns full-[N] observations and decisions, only
    the wrapped solve runs on the ``[K_pool]`` slice. Built by
    ``wrap_controller``."""

    def __init__(self, inner, cfg: HierarchyConfig, ctx: ControllerContext,
                 *, assign0, centroids, features, base_key):
        self.inner = inner
        self.cfg = cfg
        self.ctx = ctx
        self.n_clients = ctx.n_clients
        self.k_pool = cfg.resolve_pool(ctx.n_clients)
        dev = ctx.device
        self.assign0 = torch.as_tensor(np.asarray(assign0), dtype=torch.int32,
                                       device=dev)
        self._centroids = torch.as_tensor(np.asarray(centroids, np.float32),
                                          device=dev)
        self._features = torch.as_tensor(np.asarray(features, np.float32),
                                         device=dev)
        self._base_key = base_key.cpu()
        self._e_cmp = ctx.e_cmp_array()
        self.name = f"sampled({getattr(inner, 'name', type(inner).__name__)})"

    # ---- protocol forwarding ------------------------------------------
    @property
    def needs_calibration(self) -> bool:
        return bool(getattr(self.inner, "needs_calibration", False))

    def calibrate(self, u_norms, h, P) -> None:
        self.inner.calibrate(u_norms, h, P)

    def init(self, n_clients: int) -> HierarchyState:
        if n_clients != self.n_clients:
            raise ValueError(f"wrapper built for {self.n_clients} clients, "
                             f"init called with {n_clients}")
        return HierarchyState(inner=self.inner.init(n_clients),
                              assign=self.assign0.clone(),
                              key=self._base_key.clone())

    # ---- sampling -----------------------------------------------------
    def sampling_weights(self, state: HierarchyState, alive=None) -> Tensor:
        """[N] this round's sampling weights from the wrapped controller's
        deficit (uniform without one), cluster-stratified, dead or
        departed clients zeroed."""
        if hasattr(self.inner, "sampling_deficit"):
            deficit = self.inner.sampling_deficit(state.inner)
        else:
            deficit = torch.zeros(self.n_clients, dtype=torch.float32,
                                  device=state.assign.device)
        w = deficit_weights(deficit, state.assign, self.cfg.clusters,
                            self.cfg.deficit_floor)
        if alive is not None:
            w = torch.where(alive, w, 0.0)
        return w

    def pool_for(self, state: HierarchyState, round_idx: int,
                 alive=None) -> Tensor:
        """[K_pool] candidate indices of round ``round_idx``, pure in
        (state.key, round_idx, the fairness EMA)."""
        w = self.sampling_weights(state, alive)
        return pool_indices(state.key, round_idx, w, self.k_pool)

    # ---- the sampled decide path --------------------------------------
    def decide(self, obs: RoundObservation,
               state: HierarchyState) -> tuple[RoundDecision, HierarchyState]:
        n = self.n_clients
        idx = self.pool_for(state, obs.round, obs.alive)
        pick = lambda v: None if v is None else v[idx]  # noqa: E731
        pobs = RoundObservation(
            u_norms=obs.u_norms[idx], h=obs.h[idx], P=obs.P[idx],
            round=obs.round, key=obs.key, alive=pick(obs.alive),
            t_round=pick(obs.t_round), e_cmp=self._e_cmp[idx],
            e_scale=pick(obs.e_scale))
        dec_p, new_pstate = self.inner.decide(
            pobs, _gather_state(state.inner, idx, n))

        # scatter the decision: non-candidates are unselected this round
        dec = RoundDecision(
            x=_scatter(idx, dec_p.x, n), gamma=_scatter(idx, dec_p.gamma, n),
            bandwidth=_scatter(idx, dec_p.bandwidth, n),
            energy=_scatter(idx, dec_p.energy, n),
            lam=dec_p.lam, mu=_scatter(idx, dec_p.mu, n),
            n_inner=dec_p.n_inner, bw_used=dec_p.bw_used,
            fallback=dec_p.fallback,
            bits=None if dec_p.bits is None else _scatter(idx, dec_p.bits, n))

        new_inner = _scatter_state(state.inner, new_pstate, idx, n)
        if hasattr(self.inner, "observe_unsampled"):
            unsampled = torch.ones(n, dtype=torch.bool, device=idx.device)
            unsampled[idx] = False
            new_inner = self.inner.observe_unsampled(new_inner, unsampled)
        return dec, HierarchyState(inner=new_inner, assign=state.assign,
                                   key=state.key)

    # ---- open-population hook -----------------------------------------
    def reset_clients(self, state: HierarchyState,
                      mask: Tensor) -> HierarchyState:
        """Churn arrivals: fresh per-client state in the wrapped controller
        and a nearest-centroid re-cluster of the (re)arrived slots
        (idempotent while client features are static)."""
        inner = state.inner
        if hasattr(self.inner, "reset_clients"):
            inner = self.inner.reset_clients(inner, mask)
        fresh = assign_nearest(self._features, self._centroids)
        assign = torch.where(mask, fresh, state.assign)
        return HierarchyState(inner=inner, assign=assign, key=state.key)


def wrap_controller(inner, cfg: HierarchyConfig, ctx: ControllerContext, *,
                    pathloss, power, base_key, seed: int) -> SampledController:
    """Cluster the population ((seed,)-pure k-means over channel stats and
    device tier) and wrap ``inner`` in the sampled decide path."""
    feats = cluster_features(pathloss, power,
                             None if ctx.e_cmp is None else ctx.e_cmp)
    kseed = cfg.seed if cfg.seed is not None else seed
    assign0, cents = kmeans(feats, cfg.clusters, seed=kseed,
                            iters=cfg.kmeans_iters)
    return SampledController(inner, cfg, ctx, assign0=assign0,
                             centroids=cents, features=feats,
                             base_key=base_key)
