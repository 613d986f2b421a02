"""(seed,)-pure k-means clustering over channel statistics and device
tier (the port's copy of ``repro.core.hierarchy.cluster``).

Clients are clustered once when the trainer is built, on the host in
numpy (the geometry is static), over standardized log-scale features:
pathloss, transmit power and per-round computation energy (zeros without
a profile). ``cluster_features`` and ``kmeans`` are the reference's numpy
code as it is, pure in ``seed`` through ``np.random.default_rng``, so the
assignment equals the JAX package's.

``assign_nearest`` is the torch companion, on the device of its inputs:
nearest-centroid re-assignment of churn (re)arrivals through the
controller's ``reset_clients`` hook. Ties go to the lowest cluster id, as
``jnp.argmin`` gives them.
"""
from __future__ import annotations

import numpy as np
import torch


def cluster_features(pathloss, power, e_cmp=None) -> np.ndarray:
    """[N, 3] standardized log-scale feature matrix (host numpy, float64).

    Log-scale because pathloss spans orders of magnitude and the tiered
    comp-energy spread is multiplicative; standardized so no feature
    dominates the Euclidean k-means metric."""
    pathloss = np.asarray(pathloss, np.float64)
    power = np.asarray(power, np.float64)
    n = pathloss.shape[0]
    if e_cmp is None:
        e_cmp = np.zeros((n,), np.float64)
    e_cmp = np.asarray(e_cmp, np.float64)
    feats = np.stack([np.log(np.maximum(pathloss, 1e-30)),
                      np.log(np.maximum(power, 1e-30)),
                      np.log1p(e_cmp / max(e_cmp.mean(), 1e-30))], axis=1)
    mu = feats.mean(axis=0, keepdims=True)
    sd = feats.std(axis=0, keepdims=True)
    return (feats - mu) / np.where(sd > 1e-12, sd, 1.0)


def kmeans(features: np.ndarray, k: int, seed: int,
           iters: int = 25) -> tuple[np.ndarray, np.ndarray]:
    """Lloyd's k-means, pure in ``seed``: ``(assign [N] int32, centroids
    [k, F] float32)``. k-means++ seeding on a seeded draw; an empty
    cluster is re-seeded to the point farthest from its centroid, so
    every cluster id stays populated when k <= N."""
    feats = np.asarray(features, np.float64)
    n = feats.shape[0]
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if k >= n:
        # degenerate: one client per cluster (extra ids unused)
        return (np.arange(n, dtype=np.int32),
                feats.astype(np.float32))
    rng = np.random.default_rng(seed)
    # k-means++ seeding: first centroid from the seeded stream, the rest
    # d^2-weighted
    cents = [feats[rng.integers(n)]]
    for _ in range(1, k):
        d2 = np.min([np.sum((feats - c) ** 2, axis=1) for c in cents],
                    axis=0)
        tot = d2.sum()
        if tot <= 0:                      # all points coincide
            cents.append(feats[rng.integers(n)])
            continue
        cents.append(feats[rng.choice(n, p=d2 / tot)])
    cents = np.stack(cents)
    assign = np.zeros((n,), np.int32)
    for _ in range(iters):
        d2 = np.sum((feats[:, None, :] - cents[None, :, :]) ** 2, axis=2)
        new_assign = np.argmin(d2, axis=1).astype(np.int32)
        for c in range(k):
            sel = new_assign == c
            if sel.any():
                cents[c] = feats[sel].mean(axis=0)
            else:
                # re-seed an empty cluster to the globally worst-fit point
                worst = np.argmax(np.min(d2, axis=1))
                cents[c] = feats[worst]
                new_assign[worst] = c
        if (new_assign == assign).all():
            assign = new_assign
            break
        assign = new_assign
    return assign, cents.astype(np.float32)


def assign_nearest(features: torch.Tensor,
                   centroids: torch.Tensor) -> torch.Tensor:
    """[N] int32 nearest-centroid assignment (float32 distances; ties to
    the first centroid), used by ``reset_clients`` for arrivals."""
    d2 = torch.sum((features[:, None, :] - centroids[None, :, :]) ** 2, dim=2)
    return torch.argmin(d2, dim=1).to(torch.int32)
