"""Population-scale hierarchical control: clustered clients and the
deficit-sampled ``[K_pool]`` decide path (the port of
``repro.core.hierarchy``).

    from repro_torch.core.hierarchy import HierarchyConfig
    tr = FederatedTrainer(..., hierarchy=HierarchyConfig(
        clusters=4, pool_frac=0.25))

See ``config`` (the knobs; a disabled config leaves the legacy round),
``cluster`` ((seed,)-pure k-means over channel statistics and device
tier) and ``sampling`` (the ``SampledController`` wrapper and its
non-candidate semantics). The 2-D ``(clusters, clients)`` aggregation
mesh is ``repro_torch.sharding.make_hierarchy_mesh``.
"""
from .cluster import assign_nearest, cluster_features, kmeans  # noqa: F401
from .config import HierarchyConfig  # noqa: F401
from .sampling import (HierarchyState, SampledController,  # noqa: F401
                       deficit_weights, pool_indices, wrap_controller)

__all__ = ["HierarchyConfig", "HierarchyState", "SampledController",
           "assign_nearest", "cluster_features", "deficit_weights",
           "kmeans", "pool_indices", "wrap_controller"]
