"""Non-IID client partitioning via Dirichlet allocation (paper Sec. VII,
[Li et al., ICDE'22]): for each class, sample p ~ Dir_N(beta) and split that
class's samples across the N clients proportionally."""
from __future__ import annotations

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, beta: float,
                        seed: int = 0, min_size: int = 2) -> list[np.ndarray]:
    """Returns per-client index arrays. Re-samples until every client has at
    least ``min_size`` samples (standard practice)."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    n = len(labels)
    for _ in range(100):
        idx_by_client: list[list[int]] = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx_c = np.where(labels == c)[0]
            rng.shuffle(idx_c)
            p = rng.dirichlet([beta] * n_clients)
            cuts = (np.cumsum(p) * len(idx_c)).astype(int)[:-1]
            for client, part in enumerate(np.split(idx_c, cuts)):
                idx_by_client[client].extend(part.tolist())
        sizes = [len(ix) for ix in idx_by_client]
        if min(sizes) >= min_size:
            return [np.array(sorted(ix), dtype=np.int64) for ix in idx_by_client]
    raise RuntimeError("could not satisfy min_size partition")


def partition_stats(parts: list[np.ndarray], labels: np.ndarray) -> dict:
    sizes = np.array([len(p) for p in parts])
    n_classes = int(labels.max()) + 1
    class_frac = np.stack([
        np.bincount(labels[p], minlength=n_classes) / max(len(p), 1) for p in parts])
    return {"sizes": sizes, "class_fractions": class_frac,
            "size_min": int(sizes.min()), "size_max": int(sizes.max()),
            "size_std": float(sizes.std())}
