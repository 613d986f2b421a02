"""Multi-pod FL collectives: FairEnergy-compressed cross-silo aggregation
over ``torch.distributed`` (the port of ``repro.fl.collectives``).

Each pod is an FL silo; the inter-silo update exchange is the
communication FairEnergy compresses. A mesh is a ``DeviceMesh`` with the
JAX package's axis names, ``("pod", "data", "model")``
(``make_silo_mesh``). A silo's update vector is split over its
``data x model`` ranks, data-major, as the JAX ``PartitionSpec(("data",
"model"))`` splits it, and replicated over pods: each rank holds its
shard as a plain tensor (``local_shard``) and every function here takes
that shard. Each silo

  1. computes its update's norm (``silo_update_norm``: a sum of squares
     in fp32, all-reduced over the intra-silo axes, then the root),
  2. block-top-k sparsifies its shard to gamma (``block_topk``, the B-7
     kernel on the card; block-local top-k commutes with the split when
     the shard is a whole number of blocks),
  3. averages the sparse shards over the ``pod`` group: a dense
     all-reduce of the masked vector (``make_fl_allreduce``), or an
     all-gather of the compact per-block (values, int16 indices) that
     moves ``gamma * S`` on the wire (``make_sparse_fl_allreduce``).

A mean over pods is a SUM all-reduce divided by the pod count (what
``pmean`` computes; ``ReduceOp.AVG`` exists only under NCCL). NCCL and
gloo carry no int16, so the indices travel as their bytes (``uint8``,
two an index) and are viewed back. The ``make_*`` functions return a
callable on the rank's shard, as the JAX ones return a jitted function;
it records the bytes of the tensors its collectives returned in its
``result_bytes`` attribute.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..devices import resolve_device
from ..kernels.topk_sparsify.ref import keep_count
from ..sharding.fl import require_process_group
from .compression import block_topk

POD_AXIS = "pod"
SILO_AXES = ("data", "model")


def make_silo_mesh(pods: int, data: int = 1, model: int = 1,
                   device=None) -> DeviceMesh:
    """``(pod, data, model)`` mesh over every rank of the default process
    group (whose size must be ``pods * data * model``), on the GPU unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    require_process_group()
    shape = (int(pods), int(data), int(model))
    if shape[0] * shape[1] * shape[2] != dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {shape[0] * shape[1] * shape[2]} "
                         f"ranks, the process group has {dist.get_world_size()}")
    return init_device_mesh(dev.type, shape,
                            mesh_dim_names=(POD_AXIS, *SILO_AXES))


def _axis_size(mesh: DeviceMesh, name: str) -> int:
    names = tuple(mesh.mesh_dim_names or ())
    return mesh.size(names.index(name)) if name in names else 1


def local_shard(vec: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's slice of a silo's full update vector: shard
    ``data_index * n_model + model_index`` of ``data * model`` equal
    shards."""
    n_data, n_model = (_axis_size(mesh, a) for a in SILO_AXES)
    n = vec.shape[0]
    if n % (n_data * n_model):
        raise ValueError(f"{n} coordinates do not split over {n_data} x "
                         f"{n_model} silo ranks")
    i = mesh.get_local_rank("data") * n_model + mesh.get_local_rank("model")
    m = n // (n_data * n_model)
    return vec[i * m:(i + 1) * m]


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def _nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def silo_update_norm(update_vec: torch.Tensor, *, mesh: DeviceMesh = None,
                     axis_names=()) -> torch.Tensor:
    """L2 norm of a silo's update from its shards: the shard's fp32 sum of
    squares, all-reduced (SUM) on each of ``axis_names`` in turn."""
    sq = torch.sum(torch.square(update_vec.to(torch.float32)))
    for ax in axis_names:
        dist.all_reduce(sq, group=mesh.get_group(ax))
    return torch.sqrt(sq)


def compressed_psum_update(update_vec: torch.Tensor, gamma, *,
                           mesh: DeviceMesh, pod_axis: str = POD_AXIS,
                           block: int = 4096) -> torch.Tensor:
    """Sparsify this rank's shard to ``gamma`` per block, then average it
    over the pods. Returns the aggregated (dense) shard."""
    sparse, _ = block_topk(update_vec, gamma, block=block)
    dist.all_reduce(sparse, group=mesh.get_group(pod_axis))
    return sparse / _axis_size(mesh, pod_axis)


def make_fl_allreduce(mesh: DeviceMesh, gamma, *, block: int = 4096):
    """``fn(shard) -> aggregated shard``: block top-k, then a dense
    all-reduce of the masked shard over the pods (it moves S bytes)."""
    def fn(vec: torch.Tensor) -> torch.Tensor:
        out = compressed_psum_update(vec, gamma, mesh=mesh, block=block)
        fn.result_bytes = _nbytes(out)
        return out

    fn.result_bytes = 0
    return fn


def make_sparse_fl_allreduce(mesh: DeviceMesh, gamma, *, block: int = 4096,
                             quantize: bool = False):
    """``fn(shard) -> aggregated shard`` that moves ``gamma * S`` on the
    wire: each silo takes its per-block top-k as compact ``[nb, k]``
    values and int16 indices (``torch.topk``, as the JAX function uses
    ``lax.top_k``), optionally int8-quantized with one scale, all-gathers
    them over the pods and scatter-adds them into a dense buffer. Wire
    bytes per kept coordinate: 4 + 2, or 1 + 2 with ``quantize``, against
    4 for every coordinate of the dense exchange. The shard must be a
    whole number of blocks."""
    if not 1 <= block <= 1 << 15:
        raise ValueError(f"block {block}: the indices travel as int16")
    k = keep_count(gamma, block)
    group = mesh.get_group(POD_AXIS)
    n_pods = _axis_size(mesh, POD_AXIS)

    def fn(vec: torch.Tensor) -> torch.Tensor:
        n = vec.shape[0]
        if n % block:
            raise ValueError(f"the shard has {n} coordinates, not a multiple "
                             f"of the block {block}")
        nb = n // block
        rows = vec.reshape(nb, block)
        idx = torch.topk(torch.abs(rows), k, dim=1).indices        # [nb, k]
        vals = torch.gather(rows, 1, idx)                          # signed
        if quantize:
            scale = torch.clamp(torch.amax(torch.abs(vals)), min=1e-12) / 127.0
            q = torch.clamp(torch.round(vals / scale), -127, 127).to(torch.int8)
            all_q = _all_gather(q, group)                          # [pods, nb, k]
            all_scale = _all_gather(scale.reshape(1), group)       # [pods, 1]
            all_vals = all_q.to(torch.float32) * all_scale.reshape(-1, 1, 1)
            wire = (all_q, all_scale)
        else:
            all_vals = _all_gather(vals, group).to(torch.float32)
            wire = (all_vals,)
        all_idx8 = _all_gather(idx.to(torch.int16).view(torch.uint8), group)
        all_idx = all_idx8.view(torch.int16).to(torch.int64)       # [pods, nb, k]
        fn.result_bytes = _nbytes(*wire, all_idx8)
        dense = torch.zeros(nb, block, dtype=torch.float32, device=vec.device)
        for p in range(n_pods):
            dense.scatter_add_(1, all_idx[p], all_vals[p])
        return (dense / n_pods).reshape(n).to(vec.dtype)

    fn.result_bytes = 0
    return fn
