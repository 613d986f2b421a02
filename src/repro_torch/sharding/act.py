"""Activation layouts at layer boundaries (logical-axis style).

A port of ``repro.sharding.act``. Models call ``constrain(x, "batch",
"seq", "embed")`` with logical names; the launch layer maps those names to
mesh axes for the duration of a step with ``activation_rules(...)``.
Outside any such context ``constrain`` is a no-op, so the models stay
mesh-agnostic and run unchanged on plain tensors on the CPU and the card.

Inside the context an activation must be a DTensor: ``constrain``
redistributes it to the placements its logical names give
(``x.redistribute``, the counterpart of ``with_sharding_constraint``:
all-gathers, reduce-scatters or all-to-alls as the layouts require). A
plain tensor there raises: it means an input of the step was not
distributed.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .specs import axis_sizes, to_placements

_RULES: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "repro_torch_act_rules", default=None)


@contextlib.contextmanager
def activation_rules(mesh=None, **logical_to_axes):
    """e.g. activation_rules(mesh, batch=("pod","data"), heads="model",
    ff="model", vocab="model", seq_tp="model").

    ``seq_tp`` shards the residual stream's sequence dim over the tensor-
    parallel axis between layers (Megatron sequence parallelism). Passing
    the mesh enables divisibility checks (non-divisible dims fall back to
    replicated); without it the activation's own mesh is used for both.
    """
    rules = dict(logical_to_axes)
    rules["__mesh__"] = mesh
    tok = _RULES.set(rules)
    try:
        yield
    finally:
        _RULES.reset(tok)


def _axes_fit(axes, dim: int, sizes: dict):
    """Keep only a prefix of axes whose product divides dim."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    total = 1
    kept = []
    for a in axes:
        n = sizes.get(a, 1)
        if n <= 1 or dim % (total * n) != 0:
            break
        kept.append(a)
        total *= n
    if not kept:
        return None
    return tuple(kept) if len(kept) > 1 else kept[0]


def constrain(x, *logical):
    """Redistribute ``x`` to the layout its logical dim names map to under
    the active rules (unknown / None names: replicated). No-op outside
    ``activation_rules``; raises on a plain tensor inside."""
    rules = _RULES.get()
    if rules is None:
        return x
    if not isinstance(x, DTensor):
        raise TypeError(f"constrain{logical} under activation_rules got a plain "
                        f"{type(x).__name__} of shape {tuple(x.shape)}: the "
                        "step's inputs must be DTensors on the rules' mesh")
    mesh = rules["__mesh__"] if rules["__mesh__"] is not None else x.device_mesh
    sizes = axis_sizes(mesh)
    spec = tuple(_axes_fit(rules.get(name), x.shape[i], sizes) if name else None
                 for i, name in enumerate(logical))
    return x.redistribute(mesh, to_placements(spec, mesh))


def _groups(src: tuple, dst: tuple) -> list:
    """The reshape ``src`` -> ``dst`` as groups of consecutive dims of
    equal product: [(source dims, destination dims)]."""
    out, i, j = [], 0, 0
    while i < len(src) and j < len(dst):
        a, b, si, sj = src[i], dst[j], [i], [j]
        while a != b:
            if a < b:
                i += 1
                a *= src[i]
                si.append(i)
            else:
                j += 1
                b *= dst[j]
                sj.append(j)
        out.append((si, sj))
        i, j = i + 1, j + 1
    for k in range(i, len(src)):                  # trailing size-1 dims
        out[-1][0].append(k)
    for k in range(j, len(dst)):
        out[-1][1].append(k)
    return out


def _legal_view(x, shape: tuple):
    """``x.reshape(shape)`` on a DTensor, after replicating what the view
    cannot keep sharded: a dim merged into the one before it, and the
    innermost mesh axes sharding a split dim until the rest divide the
    split's leading size (4 KV heads against a 16-way ``model`` axis)."""
    mesh = x.device_mesh
    placements = list(x.placements)
    changed = False
    for si, sj in _groups(tuple(x.shape), shape):
        lead = [d for d in si if x.shape[d] > 1][:1]
        for d in si:
            axes = [j for j, p in enumerate(placements) if p.is_shard(d)]
            keep, ways = [], 1
            if d in lead:
                n0 = next((shape[k] for k in sj if shape[k] > 1), 1)
                for j in axes:
                    if n0 % (ways * mesh.size(j)):
                        break
                    keep.append(j)
                    ways *= mesh.size(j)
            for j in axes[len(keep):]:
                placements[j] = Replicate()
                changed = True
    if changed:
        x = x.redistribute(mesh, placements)
    return x.reshape(shape)


class _Reshape(torch.autograd.Function):
    """``_legal_view`` both ways: the gradient's view back is legal too."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.src = tuple(x.shape)
        return _legal_view(x, shape)

    @staticmethod
    def backward(ctx, g):
        return _legal_view(g, ctx.src), None


def reshape(x, shape):
    """``x.reshape(shape)``; on a DTensor, through ``_legal_view`` forward
    and backward, so a view into heads or groups never has to split a
    head or a group across ranks."""
    shape = tuple(int(n) for n in shape)
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    return _Reshape.apply(x, shape)


def split_dim(x, dim: int, n: int, size: int):
    """``x`` with dim ``dim`` viewed as ``(n, size)`` (``reshape``)."""
    dim = dim % x.ndim
    return reshape(x, (*x.shape[:dim], n, size, *x.shape[dim + 1:]))


def split_last(x, n: int, size: int):
    """``x`` with its last dim viewed as ``(n, size)``."""
    return split_dim(x, -1, n, size)


def chunked(x, q: int):
    """``x`` [B, S, ...] viewed as ``[B, S // q, q, ...]`` (``reshape``):
    chunk c of a chunked scan is ``chunked(x, q)[:, c]``, on a plain
    tensor the very view ``x[:, c q:(c + 1) q]``. On a DTensor all but a
    sharded batch is redistributed to replicated once here (sharded dims
    gathered, partial sums reduced), so that taking a chunk and the
    chunk's products move nothing: a slice of a DTensor whose sequence is
    sharded gathers the whole sequence again, once a chunk, a product over
    heads sharded with the batch gathers the chunk's heads (DTensor's
    einsum merges the two dims), and one over a partial sum reduces it."""
    b, s = x.shape[:2]
    y = reshape(x, (b, s // q, q, *x.shape[2:]))
    if isinstance(y, DTensor):
        placements = [p if p.is_shard(0) else Replicate() for p in y.placements]
        if placements != list(y.placements):
            y = y.redistribute(y.device_mesh, placements)
    return y


def microbatch(t, m: int, i: int):
    """Slice ``i`` of ``m`` along the batch (dim 0): the rows
    ``[i B/m, (i+1) B/m)`` of a plain tensor. On a DTensor whose batch is
    sharded, each rank's rows split alike: slice ``i`` is the ``i``-th
    ``m``-th of every rank's rows, laid out as the batch was (no
    collective; the same rows as the plain slice when the batch is not
    sharded). The slices' gradients sum to the same total."""
    if not isinstance(t, DTensor) or not any(p.is_shard(0) for p in t.placements):
        return t.reshape((m, t.shape[0] // m) + tuple(t.shape[1:]))[i]
    local = t.to_local()
    rows = local.shape[0]
    if rows % m:
        raise ValueError(f"{rows} local rows do not split into {m} microbatches")
    part = local.reshape((m, rows // m) + tuple(local.shape[1:]))[i]
    shape = (t.shape[0] // m,) + tuple(t.shape[1:])
    return DTensor.from_local(part, t.device_mesh, t.placements, run_check=False,
                              shape=shape, stride=contiguous_stride(shape))


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= max(int(n), 1)
    return tuple(reversed(out))


def matmul(x, w):
    """``x @ w`` for x ``[..., d_in]`` and w ``[d_in, d_out]``. A DTensor x
    of rank 3 or more is flattened to ``[N, d_in]`` by ``reshape`` first
    (a sequence dim sharded between layers is gathered there, not inside
    the matmul's own flatten, which torch 2.11's DTensor refuses)."""
    if not isinstance(x, DTensor) or x.ndim <= 2:
        return x @ w
    lead = tuple(x.shape[:-1])
    n = 1
    for k in lead:
        n *= k
    y = reshape(x, (n, x.shape[-1])) @ w
    return reshape(y, (*lead, y.shape[-1]))


def take_rows(table, ids):
    """``table[ids]``: rows of ``table`` [V, d] for ``ids`` [...]. On a
    DTensor ``ids`` each rank gathers from its own shard of the table (a
    table sharded on its rows gives each rank the ids in its range, and
    the rows sum over those ranks: ``Partial``), so no operator has to
    take ids sharded over two mesh axes at once (the batch over ``pod``
    and ``data``), which DTensor's gather does not."""
    if not isinstance(ids, DTensor):
        return table[ids]
    mesh = ids.device_mesh
    if not isinstance(table, DTensor):
        table = DTensor.from_local(table, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    t_pl = [p if p.is_shard(0) else Replicate() for p in table.placements]
    if t_pl != list(table.placements):
        table = table.redistribute(mesh, t_pl)
    lo, rows = 0, table.shape[0]
    for j, p in enumerate(t_pl):
        if p.is_shard(0):
            rows //= mesh.size(j)
            lo = lo * mesh.size(j) + mesh.get_local_rank(j)
    lo *= rows
    out_pl, grad_pl = [], []
    for j, (tp, ip) in enumerate(zip(t_pl, ids.placements)):
        if tp.is_shard(0):
            out_pl.append(Partial())
            grad_pl.append(Shard(0))
        else:
            out_pl.append(ip if ip.is_shard() else Replicate())
            grad_pl.append(Partial() if ip.is_shard() else Replicate())
    local_ids = ids.to_local()
    local = table.to_local(grad_placements=grad_pl)
    if rows == table.shape[0]:
        out = local[local_ids]
    else:
        mine = (local_ids >= lo) & (local_ids < lo + rows)
        idx = torch.clamp(local_ids - lo, 0, rows - 1)
        out = local[idx] * mine[..., None].to(local.dtype)
    shape = tuple(ids.shape) + tuple(table.shape[1:])
    return DTensor.from_local(out, mesh, out_pl, run_check=False, shape=shape,
                              stride=contiguous_stride(shape))
