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
is replicated is simply computed on every rank.

The two-tier hierarchy mesh (``make_hierarchy_mesh``) is 2-D, ``(clusters,
clients)``: the client axis of every stack is split over both mesh axes,
cluster-major (rank ``c * n_clients_axis + k`` holds the ``c * n_clients_axis
+ k``-th shard), and the trainer reduces in two stages, over ``clients``
(the cluster head's partial aggregate) and then over ``clusters`` (the
server's). Every helper accepts the client axis as the 1-D string or the
tuple of axis names.

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


def make_hierarchy_mesh(n_clusters: Optional[int] = None,
                        n_devices: Optional[int] = None, device=None,
                        clusters_axis: str = CLUSTERS_AXIS,
                        clients_axis: str = CLIENTS_AXIS) -> DeviceMesh:
    """Two-tier ``(clusters, clients)`` mesh for cluster-head partial
    aggregation over every rank of the default process group.
    ``n_clusters in (None, 1)`` returns the 1-D clients mesh; else the
    ranks are factored ``n_clusters x (world / n_clusters)`` and
    ``n_clusters`` must divide the world size."""
    if n_clusters is None or n_clusters == 1:
        return make_clients_mesh(n_devices, device, clients_axis)
    dev = resolve_device(device)
    require_process_group()
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"requested {n} devices but the process group has "
                         f"{world} ranks: the mesh spans the whole group")
    if n_clusters < 1 or n % n_clusters != 0:
        raise ValueError(f"{n_clusters} clusters do not divide {n} devices")
    return init_device_mesh(dev.type, (n_clusters, n // n_clusters),
                            mesh_dim_names=(clusters_axis, clients_axis))


def _dims(mesh: DeviceMesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def mesh_client_axes(mesh: DeviceMesh, axis: AxisSpec = CLIENTS_AXIS) -> tuple:
    """The client-axis names on ``mesh``: ``("clusters", "clients")`` on a
    hierarchy mesh, ``("clients",)`` on the 1-D one. The order is the
    cluster-major order client lanes are laid out in, and the reverse of
    the order the two all-reduce stages run in."""
    names = axis_names(axis)
    if len(names) == 1 and CLUSTERS_AXIS in _dims(mesh) \
            and names[0] != CLUSTERS_AXIS:
        names = (CLUSTERS_AXIS,) + names
    for a in names:
        if a not in _dims(mesh):
            raise ValueError(f"mesh has no {a!r} axis; axes: {_dims(mesh)}")
    return names


def check_clients_mesh(mesh, axis: AxisSpec = CLIENTS_AXIS) -> tuple:
    """The mesh's client axes (``mesh_client_axes``), after checking that
    ``mesh`` is a ``DeviceMesh`` made of exactly those axes, in that
    order, over every rank of the default group."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, got "
                        f"{type(mesh).__name__}")
    names = mesh_client_axes(mesh, axis)
    if _dims(mesh) != names:
        raise ValueError(f"mesh axes {_dims(mesh)} are not the client axes "
                         f"{names}")
    if mesh.mesh.flatten().tolist() != list(range(dist.get_world_size())):
        raise ValueError("the mesh must span the default process group's "
                         "ranks in order")
    return names


def clients_axis_size(mesh: DeviceMesh, axis: str = CLIENTS_AXIS) -> int:
    if axis not in _dims(mesh):
        raise ValueError(f"mesh has no {axis!r} axis; axes: {_dims(mesh)}")
    return mesh.size(_dims(mesh).index(axis))


def client_shard_count(mesh: DeviceMesh, axis: AxisSpec = CLIENTS_AXIS) -> int:
    """Number of shards the client axis splits into: the product over
    all its mesh axes."""
    count = 1
    for a in mesh_client_axes(mesh, axis):
        count *= clients_axis_size(mesh, a)
    return count


def client_shard_index(mesh: DeviceMesh, axis: AxisSpec = CLIENTS_AXIS) -> int:
    """This rank's shard of the client axis, cluster-major."""
    i = 0
    for a in mesh_client_axes(mesh, axis):
        i = i * clients_axis_size(mesh, a) + mesh.get_local_rank(a)
    return i


def shard_client_data(data: ClientData, mesh: DeviceMesh,
                      axis: AxisSpec = CLIENTS_AXIS) -> ClientData:
    """This rank's rows of the client stacks (a copy, on the stacks'
    device). The client count must already be mesh-divisible: build the
    stacks with ``stack_client_datasets(...,
    pad_to_multiple=client_shard_count(mesh))``."""
    n = data.n_clients
    size = client_shard_count(mesh, axis)
    if n % size != 0:
        raise ValueError(
            f"client count {n} does not divide the "
            f"{mesh_client_axes(mesh, axis)} mesh axes ({size}); stack with "
            f"pad_to_multiple={size} to add ghost clients")
    n_local = n // size
    i0 = client_shard_index(mesh, axis) * n_local
    take = lambda t: t[i0:i0 + n_local].clone()  # noqa: E731
    return ClientData(arrays={k: take(v) for k, v in data.arrays.items()},
                      lengths=take(data.lengths))
