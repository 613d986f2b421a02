"""Params-dict <-> flat fp32 vector, in the JAX package's leaf order.

FairEnergy works on the flattened local update u_i (its L2 norm is the
contribution score, its 4096-wide blocks are what top-k sparsifies), so
the coefficient order must be the reference's: ``jax.tree_util`` flattens
nested dicts with their keys sorted at every level, e.g. ``conv0.b,
conv0.w, conv1.b, ..., fc2.w`` for the CNN. ``leaf_order`` sorts the
dotted names by their path components, which is that order; a
``state_dict``'s insertion order (``w`` before ``b``) would move every
coefficient to another block.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


def leaf_order(names) -> list[str]:
    """Dotted parameter names in JAX's sorted pytree-leaf order."""
    return sorted(names, key=lambda n: tuple(n.split(".")))


class TreeSpec(NamedTuple):
    names: tuple
    shapes: tuple
    sizes: tuple
    dtypes: tuple


def tree_spec(params: dict) -> TreeSpec:
    names = tuple(leaf_order(params))
    return TreeSpec(names,
                    tuple(tuple(params[n].shape) for n in names),
                    tuple(int(params[n].numel()) for n in names),
                    tuple(params[n].dtype for n in names))


def flatten_update(params: dict) -> Tensor:
    """Concatenate the leaves (fp32) into one vector, in JAX leaf order."""
    return torch.cat([params[n].to(torch.float32).reshape(-1)
                      for n in leaf_order(params)])


def unflatten_update(vec: Tensor, spec: TreeSpec) -> dict:
    out, off = {}, 0
    for name, shape, size, dtype in zip(spec.names, spec.shapes, spec.sizes,
                                        spec.dtypes):
        out[name] = vec[off:off + size].reshape(shape).to(dtype)
        off += size
    return out


def update_l2_norm(tree: dict) -> Tensor:
    """||u||_2 of an update dict without the flat vector: one fp32 sum of
    squares a leaf, the leaves added in JAX leaf order, then the root."""
    sq = 0
    for n in leaf_order(tree):
        sq = sq + torch.sum(torch.square(tree[n].to(torch.float32)))
    return torch.sqrt(sq)


def finite_rows(mat: Tensor) -> Tensor:
    """[n] bool — rows of an [n, D] matrix with every coefficient finite."""
    return torch.all(torch.isfinite(mat), dim=1)


# rows of the update matrix widened to float64 at a time by weighted_sum
_SUM_ROWS = 8


def weighted_sum(w: Tensor, rows: Tensor) -> Tensor:
    """``sum_i w[i] * rows[i]`` of fp32 ``w`` [n] and ``rows`` [n, D],
    accumulated in float64 ([D] float64). Each product is exact there and
    each addition rounds at float64's ulp, 2^29 times finer than float32's,
    so two groupings of the terms (one GEMV over all clients on one card,
    or each rank's partial sum and the all-reduce across a clients mesh)
    almost never round to different float32 aggregates: the sharded
    trainer equals one card bit for bit (ROADMAP C-17). The rows are
    widened a few at a time, so no float64 copy of the matrix is made."""
    acc = torch.zeros(rows.shape[1], dtype=torch.float64, device=rows.device)
    for i in range(0, rows.shape[0], _SUM_ROWS):
        acc += w[i:i + _SUM_ROWS].double() @ rows[i:i + _SUM_ROWS].double()
    return acc
