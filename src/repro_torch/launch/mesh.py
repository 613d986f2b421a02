"""The production meshes of the sharding plan, and a mesh over the ranks
that exist.

``make_production_mesh`` returns the JAX package's TPU v5e layout as a
``torch.distributed`` ``DeviceMesh``: ``(16, 16)`` over ``("data",
"model")``, or ``(2, 16, 16)`` over ``("pod", "data", "model")`` for
multi-pod. Its 256 or 512 ranks live in torch's fake process group (the
``"fake"`` backend of ``torch.testing._internal.distributed.fake_pg`` on
a ``FakeStore``): this process is rank 0 and every collective returns at
once without moving data, which is what the dry-run
(``launch.dryrun``) needs to trace one device's share of a step. It is
the counterpart of the JAX package's 512 placeholder host devices.

Functions, not module constants: importing this module starts no process
group. ``make_production_mesh`` tears down a fake group it set up before
and starts a new one, so one process can run several meshes in turn;
``release_production_mesh`` (or the ``fake_mesh`` context) tears it
down; ``make_fake_mesh`` gives other shapes (the tests' ``(2, 2)``). ``make_host_mesh`` is the JAX package's "mesh over whatever devices
exist": ``(1, world)`` over the default group's ranks.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..devices import resolve_device

PRODUCTION_AXES = ("data", "model")
MULTI_POD_AXES = ("pod", "data", "model")

_FAKE = {"active": False}


def release_production_mesh() -> None:
    """Destroy the fake process group a production mesh set up, if any."""
    if _FAKE["active"]:
        if dist.is_initialized():
            dist.destroy_process_group()
        _FAKE["active"] = False


def make_fake_mesh(shape: tuple, axes: tuple) -> DeviceMesh:
    """A ``"cpu"`` mesh of ``shape`` over ``axes`` whose ranks are those of
    a fake process group in which this process is rank 0. Tears down a
    fake group made before; raises if a real process group is
    initialized."""
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    release_production_mesh()
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized: the "
                           "production mesh needs its own fake group")
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    world = 1
    for n in shape:
        world *= n
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    _FAKE["active"] = True
    return DeviceMesh("cpu", torch.arange(world).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """``(16, 16)`` ``("data", "model")``, or ``(2, 16, 16)`` ``("pod",
    "data", "model")``, over a fake process group (``make_fake_mesh``)."""
    if multi_pod:
        return make_fake_mesh((2, 16, 16), MULTI_POD_AXES)
    return make_fake_mesh((16, 16), PRODUCTION_AXES)


@contextlib.contextmanager
def fake_mesh(shape: tuple, axes: tuple):
    """``make_fake_mesh`` for the duration of a ``with`` block."""
    try:
        yield make_fake_mesh(shape, axes)
    finally:
        release_production_mesh()


def make_host_mesh(device=None) -> DeviceMesh:
    """``(1, world)`` over ``("data", "model")`` spanning the default
    process group's ranks, on the GPU unless ``device="cpu"``. The caller
    starts the group."""
    dev = resolve_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no torch.distributed process group: call "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    return DeviceMesh(dev.type, torch.arange(world).reshape(1, world),
                      mesh_dim_names=PRODUCTION_AXES)
