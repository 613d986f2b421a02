"""Helpers of the port's tests that import no JAX, so that ranks spawned
by the multi-rank tests load only torch and the port: the golden 12-round
MLP trainer (the draws of ``test_scan_engine.make_trainer``), a spawner of
gloo ranks with a deadline, and the bodies those ranks run.

Ranks meet through a ``file://`` store under the test's ``tmp_path``,
each runs with one thread, writes what it computed to ``rank<r>.npz``
there and destroys its process group; the test compares the files with
the JAX package in its own process.
"""
import contextlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import ChannelConfig, FairEnergyConfig, FLConfig
from repro_torch.convert import params_from_numpy
from repro_torch.fl import FederatedTrainer

# ------------------------------------------------- the golden MLP trainer ----
N_CLIENTS, D_IN, D_HIDDEN, N_CLASSES, ROUNDS = 8, 16, 24, 5, 12


def mlp_data(n_clients: int = N_CLIENTS):
    """The draws of ``test_scan_engine.make_trainer``, in its order (at
    its N = 8 the golden's)."""
    rng = np.random.default_rng(7)
    params = {"w1": rng.normal(size=(D_IN, D_HIDDEN)).astype(np.float32) * 0.1,
              "w2": rng.normal(size=(D_HIDDEN, N_CLASSES)).astype(np.float32) * 0.1}
    datasets = [{"x": rng.normal(size=(40 + 7 * i, D_IN)).astype(np.float32),
                 "y": rng.integers(0, N_CLASSES, size=40 + 7 * i)}
                for i in range(n_clients)]
    tx = rng.normal(size=(128, D_IN)).astype(np.float32)
    ty = rng.integers(0, N_CLASSES, size=128)
    return params, datasets, tx, ty


def mlp_trainer(params_tree, fe_cfg=None, *, n_clients: int = N_CLIENTS,
                **kw):
    _, datasets, tx, ty = mlp_data(n_clients)
    tx, ty = torch.tensor(tx), torch.tensor(ty)

    def loss_fn(p, batch):
        hid = torch.tanh(batch["x"] @ p["w1"])
        ll = torch.log_softmax(hid @ p["w2"], dim=-1)
        return -torch.mean(torch.gather(ll, 1, batch["y"][:, None])), {}

    def eval_fn(p):
        lg = torch.tanh(tx @ p["w1"]) @ p["w2"]
        return torch.mean((torch.argmax(lg, -1) == ty).to(torch.float32))

    return FederatedTrainer(
        model_loss=loss_fn,
        model_params=params_from_numpy(params_tree, device="cpu"),
        client_datasets=datasets, eval_fn=eval_fn,
        fl_cfg=FLConfig(local_steps=2, local_batch=16, lr=0.05),
        fe_cfg=fe_cfg or FairEnergyConfig(),
        ch_cfg=ChannelConfig(n_clients=n_clients), device="cpu", **kw)


def history_arrays(tr) -> dict:
    """A trainer's logs and final params as arrays (for ``np.savez``)."""
    h = tr.history
    out = {k: np.stack([getattr(lg, k) for lg in h])
           for k in ("selected", "gamma", "bandwidth", "energy", "battery")}
    out.update(accuracy=np.array([lg.accuracy for lg in h]),
               loss=np.array([lg.loss for lg in h]),
               params=np.concatenate([tr.params[k].numpy().ravel()
                                      for k in sorted(tr.params)]))
    if h[0].bits is not None:
        out["bits"] = np.stack([lg.bits for lg in h])
        out["e_saved"] = np.array([lg.e_saved for lg in h])
    if h[0].n_retx is not None:
        out["n_retx"] = np.array([lg.n_retx for lg in h])
        out["n_outage"] = np.array([lg.n_outage for lg in h])
    if h[0].t_round is not None:
        out["made"] = np.stack([lg.made for lg in h])
        for k in ("t_round", "n_late", "n_stale"):
            out[k] = np.array([getattr(lg, k) for lg in h])
    if h[0].n_faulted is not None:
        for k in ("n_faulted", "n_rejected", "clip_frac", "fallback"):
            out[k] = np.array([getattr(lg, k) for lg in h])
    return out


# ------------------------------------------------------------ spawning ----
def _entry(rank, world, store, body, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        body(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(body, world: int, tmp_path, *args, timeout: float = 120.0) -> list:
    """Run ``body(rank, *args)`` on ``world`` gloo ranks; fail (killing the
    ranks) past ``timeout`` seconds. Returns each rank's ``rank<r>.npz``."""
    store = os.path.join(str(tmp_path), "store")
    ctx = mp.spawn(_entry, args=(world, store, body, args), nprocs=world,
                   join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"{world} ranks of {body.__name__} did not "
                               f"finish in {timeout} s")
    return [dict(np.load(os.path.join(str(tmp_path), f"rank{r}.npz")))
            for r in range(world)]


@contextlib.contextmanager
def single_rank_group(tmp_path):
    """A one-rank gloo process group in this process, destroyed on exit."""
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(str(tmp_path), 'store1')}",
        rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _save(out_dir, rank: int, **arrays) -> None:
    np.savez(os.path.join(str(out_dir), f"rank{rank}.npz"), **arrays)


# ---------------------------------------------------------- rank bodies ----
def collectives_body(rank, shape, vecs, gamma, out_dir):
    """(pod, data, model) = ``shape``; pod p's silo update is ``vecs[p]``."""
    from repro_torch.fl import collectives as col
    mesh = col.make_silo_mesh(*shape, device="cpu")
    coords = [mesh.get_local_rank(a) for a in ("pod", "data", "model")]
    shard = col.local_shard(torch.from_numpy(vecs[coords[0]]), mesh)
    dense_fn = col.make_fl_allreduce(mesh, gamma)
    sparse_fn = col.make_sparse_fl_allreduce(mesh, gamma)
    int8_fn = col.make_sparse_fl_allreduce(mesh, gamma, quantize=True)
    out = dict(
        coords=np.array(coords), shard=shard.numpy(),
        dense=dense_fn(shard).numpy(), sparse=sparse_fn(shard).numpy(),
        int8=int8_fn(shard).numpy(),
        psum=col.compressed_psum_update(shard, gamma, mesh=mesh).numpy(),
        norm=col.silo_update_norm(shard, mesh=mesh,
                                  axis_names=("data", "model")).numpy(),
        bytes=np.array([dense_fn.result_bytes, sparse_fn.result_bytes,
                        int8_fn.result_bytes]))
    _save(out_dir, rank, **out)


def sharded_trainer_body(rank, cases, out_dir):
    """Each case (name, params tree, n_clients, fe_cfg, trainer kwargs) run
    for ``ROUNDS`` rounds on a clients mesh over every rank; also the
    divisibility error of ``shard_client_data``."""
    from repro_torch.data import stack_client_datasets
    from repro_torch.sharding import make_clients_mesh, shard_client_data
    mesh = make_clients_mesh(device="cpu")
    out = {}
    for name, params, n_clients, fe_cfg, kw in cases:
        tr = mlp_trainer(params, fe_cfg, n_clients=n_clients, mesh=mesh, **kw)
        tr.run_scanned(ROUNDS, verbose=False)
        out.update({f"{name}.{k}": v for k, v in history_arrays(tr).items()})
        out[f"{name}.n_padded"] = np.array(tr.n_padded)
    odd = stack_client_datasets(mlp_data(dist.get_world_size() + 1)[1], "cpu")
    try:
        shard_client_data(odd, mesh)
        out["divisibility_error"] = np.array("")
    except ValueError as e:
        out["divisibility_error"] = np.array(str(e))
    _save(out_dir, rank, **out)


def sweep_body(rank, params, fe_cfg, seeds, rounds, configs, out_dir):
    """``run_sweep`` of the MLP trainer on a clients mesh over every rank:
    seed lanes, then ``configs`` lanes."""
    from repro_torch.sharding import make_clients_mesh
    tr = mlp_trainer(params, fe_cfg, mesh=make_clients_mesh(device="cpu"))
    seeds_out = tr.run_sweep(seeds, rounds)
    cfg_out = tr.run_sweep(seeds, rounds, configs=configs)
    _save(out_dir, rank, **{f"seeds.{k}": v for k, v in seeds_out.items()},
          **{f"configs.{k}": v for k, v in cfg_out.items() if k != "configs"})


def checkpoint_body(rank, params, kw, ckpt_dir, out_dir):
    """The MLP trainer on a clients mesh over every rank for ``ROUNDS``
    rounds in chunks of 4, a checkpoint after each (the mesh's first rank
    writes it); then a fresh mesh trainer restored from the round-8 file
    runs the rest."""
    import os as _os
    from repro_torch.sharding import make_clients_mesh
    mesh = make_clients_mesh(device="cpu")
    a = mlp_trainer(params, mesh=mesh, **kw)
    a.run_scanned(ROUNDS, chunk=4, ckpt_dir=ckpt_dir, verbose=False)
    b = mlp_trainer(params, mesh=mesh, **kw)
    start = b.restore_checkpoint(_os.path.join(ckpt_dir, "ckpt_00000008.npz"))
    b.run_scanned(ROUNDS, chunk=4, start_round=start, verbose=False)
    _save(out_dir, rank, **{f"full.{k}": v for k, v in history_arrays(a).items()},
          **{f"resumed.{k}": v for k, v in history_arrays(b).items()})


def record_pools(tr) -> list:
    """The candidate pool of every round a sampled trainer decides on, as
    it is drawn from that round's state: the controller's ``pool_for``
    wrapped on this instance (host int64 arrays, one a call)."""
    drawn = []
    pool_for = tr.controller.pool_for

    def recording(state, round_idx, alive=None):
        idx = pool_for(state, round_idx, alive)
        drawn.append(idx.cpu().numpy())
        return idx
    tr.controller.pool_for = recording
    return drawn


def hierarchy_mesh_body(rank, params, hier_kw, out_dir):
    """The sampled MLP trainer (``HierarchyConfig(**hier_kw)``) for
    ``ROUNDS`` rounds on the 2-D ``(clusters, clients)`` mesh of two
    clusters over every rank; its logs, params, the pools as drawn and
    the assignment."""
    from repro_torch.core.hierarchy import HierarchyConfig
    from repro_torch.sharding import make_hierarchy_mesh
    mesh = make_hierarchy_mesh(2, device="cpu")
    tr = mlp_trainer(params, mesh=mesh, hierarchy=HierarchyConfig(**hier_kw))
    pools = record_pools(tr)
    tr.run_scanned(ROUNDS, verbose=False)
    _save(out_dir, rank, **history_arrays(tr), pools=np.stack(pools),
          assign=tr.ctrl_state.assign.numpy(),
          mesh_shape=np.array(tuple(mesh.shape)))


def experiments_cli_body(rank, argv, out_dir):
    """The experiment CLI with ``--shard-clients`` inside this gloo group,
    on the smoke CNN; every rank saves the results it returns."""
    from repro_torch.configs.fmnist_cnn import SMOKE
    from repro_torch.launch import experiments
    experiments.CNN_FULL = SMOKE
    res = experiments.cli(argv + ["--shard-clients"])
    _save(out_dir, rank, k=np.array(res["k"]),
          energy=np.array(res["strategies"]["fairenergy"]["energy_per_round_J"]))
