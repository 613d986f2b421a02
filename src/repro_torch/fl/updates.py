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
