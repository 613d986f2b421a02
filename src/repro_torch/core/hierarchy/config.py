"""HierarchyConfig — the two-tier control knobs (the port's copy of
``repro.core.hierarchy.config``).

* ``clusters`` — number of client clusters for the (seed,)-pure k-means
  assignment (``cluster``) and the stratification of the per-round
  candidate pool; ``clusters=1`` keeps one flat population.
* ``pool_frac`` / ``pool_size`` — per-round candidate-pool size of the
  sampled decide path (``sampling``): the wrapped controller only sees the
  gathered ``[K_pool]`` slice. ``pool_size`` (absolute) wins over
  ``pool_frac``; the resolved size is clamped to ``[1, N]``.

The default config (``pool_frac=1``, ``clusters=1``) is disabled: the
trainer then neither wraps the controller nor changes the mesh, and the
round is the legacy one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class HierarchyConfig:
    """Knobs of the two-tier (clustered, deficit-sampled) control path."""
    clusters: int = 1                 # k-means cluster count
    pool_frac: float = 1.0            # candidate pool as a fraction of N
    pool_size: Optional[int] = None   # absolute pool size (wins over frac)
    deficit_floor: float = 0.05       # exploration floor added to every
    #                                   client's sampling deficit, so that
    #                                   zero-deficit clients stay reachable
    kmeans_iters: int = 25            # Lloyd iterations (host, at init)
    seed: Optional[int] = None        # clustering seed; None = the
    #                                   trainer's seed

    def __post_init__(self):
        if self.clusters < 1:
            raise ValueError(f"clusters must be >= 1, got {self.clusters}")
        if not (0.0 < self.pool_frac <= 1.0):
            raise ValueError(f"pool_frac must be in (0, 1], got "
                             f"{self.pool_frac}")
        if self.pool_size is not None and self.pool_size < 1:
            raise ValueError(f"pool_size must be >= 1, got {self.pool_size}")
        if self.deficit_floor <= 0.0:
            raise ValueError("deficit_floor must be > 0 (a zero floor makes "
                             "zero-deficit clients unsampleable forever)")

    def resolve_pool(self, n_clients: int) -> int:
        """Concrete K_pool for an N-client population (Python's ``round``
        of ``pool_frac * N``), clamped to [1, N]."""
        if self.pool_size is not None:
            k = self.pool_size
        else:
            k = int(round(self.pool_frac * n_clients))
        return max(1, min(k, n_clients))

    def sampling_enabled(self, n_clients: int) -> bool:
        """True iff the sampled decide path changes anything: a proper
        sub-population pool, or clusters to stratify over."""
        return self.clusters > 1 or self.resolve_pool(n_clients) < n_clients
