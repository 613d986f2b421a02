"""Logical-axis -> placement rules of the sharding plan (divisibility-aware).

A port of ``repro.sharding.specs``. Parameters get 2D sharding:
tensor-parallel dims (heads*head_dim, d_ff, vocab) on the ``model`` axis;
the other matmul dim FSDP-sharded on ``data``. A dim is sharded only when
divisible by the mesh axis size (whisper's 6 heads / 51865 vocab fall back
to replication). Parameters are replicated across ``pod``: each pod is an
FL silo holding the model.

A spec is the JAX package's ``PartitionSpec`` as a plain tuple: one entry
per tensor dim, each ``None``, a mesh-axis name, or a tuple of names
(``("pod", "data")``); a shorter tuple leaves the trailing dims
replicated. ``to_placements`` turns a spec into the DTensor placements of
a ``DeviceMesh``, ``to_named`` a tree of specs.

Name-driven, as in the JAX package: the rule keys on a parameter's leaf
and parent names. The port's layers are per-layer modules where the JAX
package stacks them on a leading axis (``convert.py`` unstacks), so a
per-layer parameter ``layers.<i>.attn.wq.w`` takes the rule the JAX
package applies to ``shape[1:]`` of its stacked leaf ``layers.attn.wq.w``
(the layer index is dropped from the names): the JAX package's spec of
the stack is ``(None,) +`` the port's. The hybrid's ``shared_attn`` is
not stacked in either package. Per-layer caches are likewise one rank
less than the JAX package's stacked ones.

A mesh here is a ``DeviceMesh`` (its ``mesh_dim_names`` and sizes), a
dict of axis sizes, or anything with such a dict as ``.shape`` (the JAX
package's ``Mesh``, the tests' stand-in); an axis it lacks has size 1.
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

# parents whose "w" contracts over the TP dim (output projections)
_OUT_PROJ = {"wo", "down", "out_proj", "fc2", "wv_head"}
# parents whose "w" expands into the TP dim
_IN_PROJ = {"wq", "wk", "wv", "gate", "up", "fc1", "in_proj", "wr", "wg",
            "vision_proj", "wk_ffn"}


def axis_sizes(mesh) -> dict:
    """Axis name -> size of a ``DeviceMesh``, a dict, or a mesh-like
    object with a dict ``.shape``."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(mesh.shape)


def _axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def _maybe(mesh, axis: str, dim: int):
    """Shard on `axis` only if the dim divides evenly."""
    n = _axis_size(mesh, axis)
    return axis if dim % max(n, 1) == 0 and n > 1 else None


def _rule(mesh, names: list, shape: tuple, fsdp: str, tp: str) -> tuple:
    leaf = names[-1]
    parent = names[-2] if len(names) > 1 else ""
    nd = len(shape)

    if leaf == "table" and nd == 2:                       # [vocab, d_model]
        # vocab on model; d_model replicated (the JAX package's measured
        # choice: FSDP on d_model all-gathers the token stream)
        return (_maybe(mesh, tp, shape[0]), None)
    if leaf in ("w_gate", "w_up") and nd == 3:            # [E, d_model, ff]
        return (None, _maybe(mesh, fsdp, shape[1]), _maybe(mesh, tp, shape[2]))
    if leaf == "w_down" and nd == 3:                      # [E, ff, d_model]
        return (None, _maybe(mesh, tp, shape[1]), _maybe(mesh, fsdp, shape[2]))
    if leaf == "conv_w" and nd == 2:                      # [K, conv_dim]
        return (None, _maybe(mesh, tp, shape[1]))
    if leaf == "wA" and nd == 2:                          # [d, r]
        return (_maybe(mesh, fsdp, shape[0]), None)
    if leaf == "wB" and nd == 2:                          # [r, d]
        return (None, _maybe(mesh, fsdp, shape[1]))
    if leaf == "pos_embed" and nd == 2:
        return (None, _maybe(mesh, fsdp, shape[1]))
    if leaf == "w" and nd == 2:
        if parent in _OUT_PROJ:                           # [tp_dim, d_model]
            return (_maybe(mesh, tp, shape[0]), _maybe(mesh, fsdp, shape[1]))
        if parent in _IN_PROJ or parent == "router":      # [d_model, tp_dim]
            tp_ax = None if parent == "router" else _maybe(mesh, tp, shape[1])
            return (_maybe(mesh, fsdp, shape[0]), tp_ax)
        return (_maybe(mesh, fsdp, shape[0]), _maybe(mesh, tp, shape[1]))
    if leaf == "w" and nd == 4:                           # CNN conv [3,3,ci,co]
        return (None, None, None, _maybe(mesh, tp, shape[3]))
    if leaf == "b" and nd == 1 and parent in _IN_PROJ:
        return (_maybe(mesh, tp, shape[0]),)
    return ()                                             # replicate


def rule_names(name: str) -> list:
    """A parameter's dotted name as the JAX package's path names: the
    layer index after a ``*layers`` component dropped."""
    parts = name.split(".")
    return [p for i, p in enumerate(parts)
            if not (p.isdigit() and i > 0 and parts[i - 1].endswith("layers"))]


def param_specs(params_shape: dict, mesh, *, fsdp: str = "data",
                tp: str = "model") -> dict:
    """params_shape: name -> tensor (any device, ``meta`` too) -> name ->
    spec."""
    specs = {}
    for name, leaf in params_shape.items():
        shape = tuple(leaf.shape)
        spec = _rule(mesh, rule_names(name), shape, fsdp, tp)
        if len(spec) > len(shape):                        # scalar leaves
            spec = (None,) * len(shape)
        specs[name] = spec
    return specs


def batch_axes(mesh, global_batch: int, *, include_model: bool = False):
    """Mesh axes to shard the batch dim over (pod+data when both divide);
    include_model=True adds the model axis (the DP-only layout for small
    models)."""
    names = ("pod", "data", "model") if include_model else ("pod", "data")
    axes = [a for a in names if _axis_size(mesh, a) > 1]
    size = 1
    used = []
    for a in axes:
        if global_batch % (size * _axis_size(mesh, a)) == 0:
            used.append(a)
            size *= _axis_size(mesh, a)
    return tuple(used) or None


def _tree_map(fn, tree, path=()):
    """``fn(path names, leaf)`` over the dicts and lists of ``tree`` (a
    tuple is a leaf: a spec)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(path, tree)


def data_specs(batch_tree, mesh, global_batch: int):
    """Inputs: batch dim on (pod,data); all other dims replicated. A
    single axis is named alone, as JAX's ``PartitionSpec`` canonicalizes
    a 1-tuple."""
    ba = batch_axes(mesh, global_batch)
    if ba is not None and len(ba) == 1:
        ba = ba[0]

    def spec_of(_, leaf):
        if leaf.ndim == 0:
            return ()
        return (ba,) + (None,) * (leaf.ndim - 1)
    return _tree_map(spec_of, batch_tree)


def cache_specs(cache_tree, mesh, batch: int, *, tp: str = "model"):
    """KV / recurrent cache sharding for decode, one spec a per-layer
    leaf.

    Batch dim (axis 0) on data when divisible; otherwise (batch=1 long
    context) the KV cache's *sequence* dim is sharded on data (context
    parallelism). Head-like dims go on ``model`` when divisible.
    """
    data_ok = batch % max(_axis_size(mesh, "data"), 1) == 0 \
        and _axis_size(mesh, "data") > 1
    bspec = "data" if data_ok else None

    def spec_of(path, leaf):
        shape = tuple(leaf.shape)
        leafname = path[-1] if path else ""
        if leafname in ("k", "v") and len(shape) == 4:       # [B,W,KV,hd]
            kvspec = _maybe(mesh, tp, shape[2])
            # seq dim: on data when batch can't shard (long-context b=1);
            # on model when KV heads don't divide the TP axis (GQA with
            # few KV heads)
            if data_ok:
                sspec = _maybe(mesh, tp, shape[1]) if kvspec is None else None
            else:
                sspec = _maybe(mesh, "data", shape[1])
            return (bspec, sspec, kvspec, None)
        if leafname == "state" and len(shape) == 4:          # [B,H,M/N,P]
            return (bspec, _maybe(mesh, tp, shape[1]), None, None)
        if leafname == "conv" and len(shape) == 3:           # [B,K-1,conv_dim]
            return (bspec, None, _maybe(mesh, tp, shape[2]))
        if leafname in ("shift", "ffn_shift") and len(shape) == 3:
            return (bspec, None, None)
        return (None,) * len(shape)
    return _tree_map(spec_of, cache_tree)


def to_placements(spec: tuple, mesh: DeviceMesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that tensor dim ``d`` names, ``Replicate()`` elsewhere. A
    dim over several axes shards over them in mesh order, the major one
    first (``("pod", "data")`` pod-major, as JAX does); an order that
    disagrees with the mesh's raises."""
    dims = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in dims]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [dims.index(a) for a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {names} are not in the mesh's "
                             f"order {dims}")
        for j in idx:
            if not isinstance(out[j], Replicate):
                raise ValueError(f"spec {spec} uses mesh axis {dims[j]} twice")
            out[j] = Shard(d)
    return out


def to_named(spec_tree, mesh: DeviceMesh):
    """A tree of specs -> the same tree of placement lists."""
    return _tree_map(lambda _, s: to_placements(s, mesh), spec_tree)
