"""Client-axis sharding of the trainer over ``torch.distributed``.

The trainer holds every client's ``[N, L, ...]`` data stack and ``[N, D]``
update buffer on one device. A ``clients`` mesh spreads that client axis
over the ranks of a process group:

* a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default
  process group, with the JAX package's axis name (``("clients",)``) as its
  ``mesh_dim_names``; a reduction over the axis is a collective on
  ``mesh.get_group("clients")``;
* each rank holds its shard as plain tensors: rank r owns rows
  ``[r * n_local, (r + 1) * n_local)`` of the ghost-padded client stack
  (``shard_client_data``), runs the client step, the sparsify and the
  weighted partial aggregate on them, and all-reduces the partial sums;
* the tiny per-client observables the controller reads (``u_norms``,
  ``h``, ``P``, all ``[N]``) are all-gathered or replicated, so selection
  runs on the same global observation in every layout;
* on timed rounds with the staleness buffer, each rank holds the buffer
  rows of its own clients (``core.rounds.AsyncState``), like the update
  buffer; the defended aggregator's clip gathers the [N] row norms and
  participation, and its trimmed mean gathers the whole update matrix;
* model params, controller state, battery, the defense tracker
  (``core.faults.DefenseState``), the link state and the round logs are
  replicated: every rank computes them from the same gathered inputs.

``N`` must divide the mesh: ``stack_client_datasets(...,
pad_to_multiple=...)`` appends zero-weight ghost clients.

The JAX package's ``PartitionSpec`` helpers (``client_stack_spec``,
``client_data_specs``, ``replicated_specs``, ``async_state_specs``,
``defense_state_specs``, ``link_state_specs``) have no counterpart here:
a rank's shard is a slice of the stack (and of the stale buffer), and what
is replicated is simply computed on every rank. The two-tier ``(clusters, clients)`` hierarchy
mesh is ROADMAP A-15.

A process group that is not initialized is an error: nothing here starts
one (``torch.distributed.init_process_group`` with ``gloo`` for CPU
tensors, ``nccl`` for CUDA ones).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..data.pipeline import ClientData
from ..devices import resolve_device

CLIENTS_AXIS = "clients"
CLUSTERS_AXIS = "clusters"

AxisSpec = Union[str, Sequence[str]]


def axis_names(axis: AxisSpec) -> tuple:
    """The mesh-axis names a client axis maps onto, as a tuple."""
    return (axis,) if isinstance(axis, str) else tuple(axis)


def require_process_group() -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group: call "
            "torch.distributed.init_process_group (backend 'nccl' for the "
            "GPU, 'gloo' for the CPU) on every rank first")


def make_clients_mesh(n_devices: Optional[int] = None, device=None,
                      axis: str = CLIENTS_AXIS) -> DeviceMesh:
    """1-D mesh with a single ``clients`` axis over every rank of the
    default process group, on the GPU unless ``device="cpu"``.
    ``n_devices``, when given, must equal the group's world size."""
    dev = resolve_device(device)
    require_process_group()
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"need at least one device, got {n}")
    if n != world:
        raise ValueError(f"requested {n} devices but the process group has "
                         f"{world} ranks: the mesh spans the whole group")
    return init_device_mesh(dev.type, (n,), mesh_dim_names=(axis,))


def make_hierarchy_mesh(*args, **kwargs):
    raise NotImplementedError("the (clusters, clients) hierarchy mesh is not "
                              "ported yet: ROADMAP A-15")


def _client_axes(axis: AxisSpec) -> str:
    names = axis_names(axis)
    if len(names) != 1 or CLUSTERS_AXIS in names:
        raise NotImplementedError(
            f"a client axis over {names} (the hierarchy mesh) is not ported "
            "yet: ROADMAP A-15")
    return names[0]


def check_clients_mesh(mesh, axis: AxisSpec = CLIENTS_AXIS) -> str:
    """The name of the mesh's client axis, after checking that ``mesh`` is
    a 1-D ``DeviceMesh`` carrying it."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, got "
                        f"{type(mesh).__name__}")
    name = _client_axes(axis)
    names = tuple(mesh.mesh_dim_names or ())
    if mesh.ndim != 1 or CLUSTERS_AXIS in names:
        raise NotImplementedError(
            f"a {mesh.ndim}-D mesh {names} splits the client axis over "
            "several mesh axes (the hierarchy mesh), not ported yet: "
            "ROADMAP A-15")
    if name not in names:
        raise ValueError(f"mesh has no {name!r} axis; axes: {names}")
    return name


def clients_axis_size(mesh: DeviceMesh, axis: str = CLIENTS_AXIS) -> int:
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh has no {axis!r} axis; axes: {names}")
    return mesh.size(names.index(axis))


def client_shard_count(mesh: DeviceMesh, axis: AxisSpec = CLIENTS_AXIS) -> int:
    """Number of shards the client axis splits into."""
    return clients_axis_size(mesh, _client_axes(axis))


def shard_client_data(data: ClientData, mesh: DeviceMesh,
                      axis: AxisSpec = CLIENTS_AXIS) -> ClientData:
    """This rank's rows of the client stacks (a copy, on the stacks'
    device). The client count must already be mesh-divisible: build the
    stacks with ``stack_client_datasets(...,
    pad_to_multiple=client_shard_count(mesh))``."""
    name = _client_axes(axis)
    n = data.n_clients
    size = client_shard_count(mesh, name)
    if n % size != 0:
        raise ValueError(
            f"client count {n} does not divide the {axis_names(axis)} mesh "
            f"axes ({size}); stack with pad_to_multiple={size} to add ghost "
            f"clients")
    n_local = n // size
    i0 = mesh.get_local_rank(name) * n_local
    take = lambda t: t[i0:i0 + n_local].clone()  # noqa: E731
    return ClientData(arrays={k: take(v) for k, v in data.arrays.items()},
                      lengths=take(data.lengths))
