"""Multi-pod FL aggregation with FairEnergy compression over
``torch.distributed``: the port of ``examples/multipod_fl.py``.

Each pod is an FL silo; the cross-pod update exchange is block-top-k
sparsified to gamma (``repro_torch.fl.collectives``). Two exchange
formats: a dense all-reduce of the masked update (it still moves S bytes)
and a sparse all-gather of int8 values and int16 indices (the paper's
gamma * S + I payload). Prints the collective result bytes of each, the
saving, and the int8 aggregate's relative error.

    # 8 CPU ranks under gloo (2 pods x 2 x 2), as the JAX example runs
    PYTHONPATH=src python -m repro_torch.launch.multipod --device cpu \\
        --pods 2 --data 2 --model 2
    # on the GPUs: one rank per card (the mesh may not exceed them)
    PYTHONPATH=src python -m repro_torch.launch.multipod --pods 2

Without ``torchrun``'s environment the CLI starts its own process group,
one rank per mesh position, as ``torchrun`` would (a ``file://`` store in
a temporary directory); under ``torchrun`` it joins the given one. Every
silo holds the same update (seed ``--seed``), split over its data x model
ranks, as in the JAX example. Collective bytes are counted per rank from
the tensors each collective returns (the JAX example counts the result
bytes of the compiled program's collectives).
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..devices import rank_device, resolve_device
from ..fl.collectives import (local_shard, make_fl_allreduce,
                              make_silo_mesh, make_sparse_fl_allreduce)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--gamma", type=float, default=0.25)
    ap.add_argument("--n", type=int, default=1 << 18,
                    help="coordinates of a silo's update")
    ap.add_argument("--block", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu, or the GPU when omitted")
    return ap.parse_args(argv)


def exchange(args: argparse.Namespace, device) -> dict:
    """Run both exchanges on this rank (inside an initialized process
    group); returns the numbers rank 0 prints."""
    mesh = make_silo_mesh(args.pods, args.data, args.model, device=device)
    vec = np.random.default_rng(args.seed).normal(size=args.n).astype(np.float32)
    shard = local_shard(torch.from_numpy(vec).to(device), mesh)
    dense = make_fl_allreduce(mesh, args.gamma, block=args.block)
    sparse = make_sparse_fl_allreduce(mesh, args.gamma, block=args.block,
                                      quantize=True)
    agg_d, agg_s = dense(shard), sparse(shard)
    err = torch.stack([(agg_s - agg_d).abs().max(), agg_d.abs().max()])
    dist.all_reduce(err, op=dist.ReduceOp.MAX)
    return dict(n=args.n, gamma=args.gamma, world=dist.get_world_size(),
                device=str(device), dense_bytes=dense.result_bytes,
                sparse_bytes=sparse.result_bytes,
                rel_err=float(err[0] / err[1]))


def report(res: dict) -> str:
    d, s = res["dense_bytes"], res["sparse_bytes"]
    return "\n".join([
        f"update: {res['n']} coords, gamma={res['gamma']}, "
        f"{res['world']} ranks on {res['device']}",
        f"dense-masked all-reduce : {d / 2**20:.2f} MiB collective result bytes",
        f"sparse int8+int16 gather: {s / 2**20:.2f} MiB ({1 - s / d:.0%} fewer)",
        f"aggregate rel. error from int8 quantization: {res['rel_err']:.4f}"])


def _rank(rank: int, world: int, args: argparse.Namespace, init: str,
          local_rank: int) -> None:
    dev = rank_device(args.device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init, rank=rank, world_size=world)
    try:
        res = exchange(args, dev)
        if rank == 0:
            print(report(res), flush=True)
    finally:
        dist.destroy_process_group()


def _spawned(rank: int, world: int, args: argparse.Namespace, init: str):
    _rank(rank, world, args, init, rank)


def main(argv=None) -> int:
    args = parse_args(argv)
    world = args.pods * args.data * args.model
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:     # torchrun
        if int(os.environ["WORLD_SIZE"]) != world:
            raise SystemExit(f"a {args.pods} x {args.data} x {args.model} mesh "
                             f"needs {world} ranks, torchrun started "
                             f"{os.environ['WORLD_SIZE']}")
        _rank(int(os.environ["RANK"]), world, args, "env://",
              int(os.environ.get("LOCAL_RANK", 0)))
        return 0
    dev = resolve_device(args.device)
    if dev.type == "cuda" and world > torch.cuda.device_count():
        raise SystemExit(f"a {args.pods} x {args.data} x {args.model} mesh "
                         f"needs {world} GPUs, {torch.cuda.device_count()} "
                         "are visible (one rank per card)")
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'store')}"
        if world == 1:
            _spawned(0, 1, args, init)
        else:
            torch.multiprocessing.spawn(_spawned, args=(world, args, init),
                                        nprocs=world, join=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
