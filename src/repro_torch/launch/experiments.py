"""The paper's experiment (Figs. 1-3, Table I): FairEnergy against the
baselines, over seeds and hyper-parameter lanes — the port of
``benchmarks/fl_experiments.py``.

The setting is the paper's Sec. VII: N clients, the FMNIST CNN (D =
1,630,090), non-IID Dirichlet (beta = 0.3) FMNIST-like data, B_tot = 10
MHz, P_i ~ U[0.1, 0.3] mW, gamma in [0.1, 1], pi_min = 0.2, rho = 0.6, lr
0.05 with 2 local steps. The protocol: FairEnergy runs first and fixes
the baselines' K (its mean selection count), EcoRandom's gamma (its
smallest selected gamma) and bandwidth (its median selected bandwidth);
then the baselines run; with ``--seeds`` every strategy runs a seed sweep
(``run_sweep``), and with ``--sweep-eta/-rho/-btot`` FairEnergy runs the
crossed config lanes. The CNN starts from ``init_cnn(PRNGKey(seed))``,
the JAX package's weights for the seed.

    # on the CPU, a small run
    PYTHONPATH=src python -m repro_torch.launch.experiments --device cpu \\
        --clients 8 --rounds 4
    # on the GPU (the default device), the paper's recipe with extras
    PYTHONPATH=src python -m repro_torch.launch.experiments --clients 50 \\
        --rounds 60 --extra-baselines --seeds 2 --sweep-eta 1e-4,3e-4

    # timed rounds and faults: a scenario, with the reference's overrides
    PYTHONPATH=src python -m repro_torch.launch.experiments --device cpu \
        --clients 8 --rounds 4 --scenario straggler --deadline 0.02
    PYTHONPATH=src python -m repro_torch.launch.experiments --device cpu \
        --clients 8 --rounds 4 --scenario byzantine-lite --fault-rate 0.3

    # population-scale control: k-means clusters and a sampled pool, with
    # the pathloss drift of moving clients
    PYTHONPATH=src python -m repro_torch.launch.experiments --device cpu \
        --clients 8 --rounds 4 --clusters 2 --pool-frac 0.5 \
        --mobility-sigma 3

``--deadline``/``--staleness-a`` (timed rounds), ``--fault-rate``/
``--crash-rate``/``--churn`` (fault injection), ``--defense`` (the
defended aggregator), ``--clusters``/``--pool-frac`` (the hierarchy) and
``--mobility-sigma`` (the pathloss drift) take the reference's semantics:
with a scenario they override its preset, without one they build the
reference's configs.

``--shard-clients`` shards the client axis over a ``clients`` mesh
(``sharding.make_clients_mesh``; N is ghost-padded to the mesh), one rank
a card, as ``launch/multipod.py`` starts them: inside a process group the
caller already made (the tests' gloo ranks) the CLI runs on it; under
``torchrun`` it joins the given one; otherwise it spawns one rank per
visible card (one gloo rank with ``--device cpu``) through a ``file://``
store. Every rank runs ``run_all`` on the mesh; rank 0 alone prints and
writes the JSON, which equals the unsharded run's (C-17).

    # 4 ranks, one a card
    PYTHONPATH=src python -m repro_torch.launch.experiments --clients 50 \
        --rounds 60 --shard-clients
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import tempfile
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import random as prng
from ..configs import ChannelConfig, FairEnergyConfig, FLConfig
from ..configs.fmnist_cnn import CONFIG as CNN_FULL
from ..core.channel import MobilityConfig
from ..core.faults import DefenseConfig, FaultConfig
from ..core.hierarchy import HierarchyConfig
from ..core.link import LinkConfig
from ..core.rounds import AsyncConfig
from ..data import ClientDataset, dirichlet_partition, make_fmnist_like
from ..devices import rank_device, resolve_device
from ..fl import FederatedTrainer
from ..models import CNN, cnn_loss, init_cnn
from ..scenarios import available_scenarios, get_scenario
from ..sharding import make_clients_mesh

DATA_KW = dict(confusion=0.55, label_noise=0.05, noise=0.9)
DEFAULT_OUT = "experiments/fl_results_torch.json"
# the JAX package's recorded example: never written by this module
PROTECTED_OUT = "experiments/fl_example.json"


def build(n_clients=20, rounds=60, n_train=12000, n_test=2000, seed=0,
          lr=0.05, local_steps=2, scenario=None, deadline=None,
          staleness_a=None, fault_rate=None, crash_rate=None, churn=None,
          defense=None, clusters=None, pool_frac=None, mobility_sigma=None,
          max_retx=None, burst_p=None, price_outage=None, bits_grid=None,
          mesh=None, device=None):
    """The experiment's recipe: returns ``(make, fl_cfg)``, where
    ``make(controller, **trainer_kw)`` builds a ``FederatedTrainer`` on
    the shared data, weights and channel, sharded over ``mesh`` (a
    ``clients`` mesh) unless ``trainer_kw`` names another.
    ``device=None`` is the GPU."""
    dev = resolve_device(device)
    cfg = CNN_FULL
    scn = get_scenario(scenario) if isinstance(scenario, str) else scenario
    beta = scn.beta(0.3) if scn else 0.3
    ch_cfg = ChannelConfig(n_clients=n_clients)
    fe_cfg = FairEnergyConfig()
    extra = {}
    if clusters is not None or pool_frac is not None:
        extra["hierarchy"] = HierarchyConfig(
            clusters=clusters if clusters is not None else 1,
            pool_frac=pool_frac if pool_frac is not None else 1.0)
    if scn:
        ch_cfg = scn.apply_channel(ch_cfg)
        fe_cfg = scn.apply_fe(fe_cfg)
        extra.update(device_profile=scn.device_profile(n_clients, seed=seed),
                     async_cfg=scn.async_config(deadline_s=deadline,
                                                staleness_a=staleness_a),
                     fault_cfg=scn.fault_config(crash_rate=crash_rate,
                                                corrupt_rate=fault_rate),
                     defense=scn.defense_config(defended=defense),
                     mobility=scn.mobility_config(sigma_db=mobility_sigma),
                     link_cfg=scn.link_config(max_retx=max_retx,
                                              burst_p=burst_p,
                                              price_outage=price_outage))
    else:
        if mobility_sigma is not None and mobility_sigma > 0.0:
            extra["mobility"] = MobilityConfig(sigma_db=mobility_sigma)
        if deadline is not None:
            extra["async_cfg"] = AsyncConfig(
                deadline_s=deadline,
                staleness_a=staleness_a if staleness_a is not None else 0.5)
        if fault_rate or crash_rate or churn:
            fault = FaultConfig(crash_rate=crash_rate or 0.0,
                                corrupt_rate=fault_rate or 0.0,
                                churn_dwell=4 if churn else 0,
                                churn_away=churn or 0.3)
            extra["fault_cfg"] = fault if fault.enabled else None
        if defense:
            extra["defense"] = DefenseConfig()
        if burst_p or price_outage or max_retx is not None:
            link = LinkConfig(outage=True,
                              max_retx=max_retx if max_retx is not None else 2,
                              burst_p=burst_p or 0.0,
                              i_burst_n0=99.0 if burst_p else 0.0,
                              price_outage=bool(price_outage))
            extra["link_cfg"] = link if link.enabled else None
    if bits_grid is not None:
        # an explicit grid wins over the scenario's: the solver decides on
        # the joint (gamma, bits) grid and the round quantizes at it
        fe_cfg = dataclasses.replace(
            fe_cfg, bits_grid=tuple(float(b) for b in bits_grid))
    imgs, labels = make_fmnist_like(n_train, seed=seed, **DATA_KW)
    ti, tl = make_fmnist_like(n_test, seed=seed + 999,
                              **dict(DATA_KW, label_noise=0.0))
    parts = dirichlet_partition(labels, n_clients, beta, seed=seed)
    fl_cfg = FLConfig(rounds=rounds, local_batch=64, local_steps=local_steps,
                      lr=lr, dirichlet_beta=beta)
    datasets = [ClientDataset(imgs[p], labels[p], fl_cfg.local_batch, seed=i)
                for i, p in enumerate(parts)]
    params = init_cnn(prng.PRNGKey(seed), cfg, device=dev)
    # the module only defines the forward; its own weights are never used
    model = CNN(cfg, torch.Generator().manual_seed(0)).to(dev)
    ti_t = torch.as_tensor(ti, device=dev)
    tl_t = torch.as_tensor(tl, device=dev).long()

    def eval_fn(p):
        logits = torch.func.functional_call(model, p, (ti_t,))
        return torch.mean((torch.argmax(logits, -1) == tl_t).to(torch.float32))

    def make(controller, **kw):
        kw.setdefault("mesh", mesh)
        return FederatedTrainer(model_loss=cnn_loss(model), model_params=params,
                                client_datasets=datasets, eval_fn=eval_fn,
                                fl_cfg=fl_cfg, fe_cfg=fe_cfg, ch_cfg=ch_cfg,
                                controller=controller, seed=seed, device=dev,
                                **extra, **kw)
    return make, fl_cfg


def run_all(n_clients=20, rounds=60, target=0.80, seed=0, verbose=True,
            extra_baselines=False, eval_every=1, sweep_seeds=None,
            config_sweep=None, monitor: Optional[Callable] = None,
            **build_kw):
    """FairEnergy first (it fixes K and the eco parameters), then the
    baselines, each through ``run_scanned``; with ``sweep_seeds`` every
    strategy's seed sweep, with ``config_sweep`` (``{"eta": [...], ...}``,
    lanes) FairEnergy's config lanes over the sweep's seeds. Returns the
    reference's results dict.

    ``monitor(event, phase, name, obj)``, if given, is called with
    ``"before"`` and ``"after"`` around each run: phase ``"run"`` (obj:
    the trainer), ``"sweep"`` or ``"config_sweep"`` (obj: ``run_sweep``'s
    outputs after, None before)."""
    make, fl_cfg = build(n_clients=n_clients, rounds=rounds, seed=seed,
                         **build_kw)
    watch = monitor or (lambda *a: None)

    def scanned(name, **kw):
        tr = make(name, **kw)
        watch("before", "run", name, None)
        tr.run_scanned(rounds, eval_every=eval_every, verbose=verbose)
        watch("after", "run", name, tr)
        return tr

    t0 = time.time()
    fe = scanned("fairenergy")
    k = max(1, int(round(np.mean([lg.n_selected for lg in fe.history]))))
    eco_gamma = float(min((g for lg in fe.history for g in lg.gamma[lg.selected]),
                          default=0.1))
    # EcoRandom's "bandwidth observed for FairEnergy": the median selected
    # allocation (the literal minimum is ~0 Hz for marginal clients)
    bws = [b for lg in fe.history for b in lg.bandwidth[lg.selected] if b > 0]
    eco_bw = float(np.median(bws)) if bws else fe.ch_cfg.bandwidth_total / max(k, 1)

    runs = {"fairenergy": fe}
    strategies = ["scoremax", "ecorandom"] + (
        ["randomfull", "channelgreedy"] if extra_baselines else [])
    base_kw = dict(fixed_k=k, eco_gamma=eco_gamma, eco_bandwidth=eco_bw)
    for s in strategies:
        runs[s] = scanned(s, **base_kw)

    scn = build_kw.get("scenario")
    results = {"k": k, "eco_gamma": eco_gamma, "eco_bandwidth": eco_bw,
               "rounds": rounds, "n_clients": n_clients,
               "scenario": (scn if isinstance(scn, str) or scn is None
                            else scn.name),
               "elapsed_s": round(time.time() - t0, 1), "strategies": {}}
    for name, tr in runs.items():
        part = tr.participation_counts()
        entry = results["strategies"][name] = {
            "accuracy": tr.accuracy_curve().tolist(),
            "energy_per_round_J": tr.energy_per_round().tolist(),
            "energy_to_target_J": tr.energy_to_accuracy(target),
            "participation": {"min": int(part.min()), "max": int(part.max()),
                              "std": float(part.std())},
            "mean_selected": float(np.mean([lg.n_selected for lg in tr.history])),
            "mean_gamma": tr.mean_gamma_selected(),
        }
        if tr.history and tr.history[0].t_round is not None:
            entry.update(
                simulated_time_s=tr.simulated_time(),
                wallclock_to_target_s=tr.wallclock_to_accuracy(target),
                n_late=int(sum(lg.n_late for lg in tr.history)),
                n_stale=int(sum(lg.n_stale for lg in tr.history)))
        if tr.history and tr.history[0].n_faulted is not None:
            entry.update(
                n_faulted=int(sum(lg.n_faulted for lg in tr.history)),
                n_rejected=int(sum(lg.n_rejected for lg in tr.history)),
                mean_clip_frac=float(np.mean([lg.clip_frac
                                              for lg in tr.history])),
                n_fallback_rounds=int(sum(bool(lg.fallback)
                                          for lg in tr.history)))
        if tr.history and tr.history[0].n_retx is not None:
            entry.update(
                n_retx=int(sum(lg.n_retx for lg in tr.history)),
                n_outage=int(sum(lg.n_outage for lg in tr.history)),
                mean_goodput_frac=float(np.mean([lg.goodput_frac
                                                 for lg in tr.history])),
                e_retx_J=float(sum(lg.e_retx for lg in tr.history)))
        if tr.history and tr.history[0].bits is not None:
            sel_bits = [b for lg in tr.history for b in lg.bits[lg.selected]]
            entry.update(
                mean_bits=float(np.mean(sel_bits)) if sel_bits else 32.0,
                e_saved_J=float(sum(lg.e_saved for lg in tr.history)))

    if sweep_seeds:
        sweep = {"seeds": [int(s) for s in sweep_seeds], "strategies": {}}
        for name in runs:
            tr = make(name, **({} if name == "fairenergy" else base_kw))
            watch("before", "sweep", name, None)
            outs = tr.run_sweep(sweep_seeds, rounds, eval_every=eval_every)
            watch("after", "sweep", name, outs)
            acc, energy = outs["accuracy"], outs["energy"].sum(-1)
            with warnings.catch_warnings():
                # eval_every-skipped rounds are NaN in every lane
                warnings.simplefilter("ignore", RuntimeWarning)
                acc_mean = np.nanmean(acc, axis=0).tolist()
                acc_std = np.nanstd(acc, axis=0).tolist()
            sweep["strategies"][name] = {
                "final_acc_mean": float(np.nanmean(acc[:, -1])),
                "final_acc_std": float(np.nanstd(acc[:, -1])),
                "acc_mean": acc_mean,
                "acc_std": acc_std,
                "energy_per_round_mean_J": float(energy.mean()),
                "energy_per_round_std_J": float(energy.mean(1).std()),
            }
        results["sweep"] = sweep
        results["elapsed_s"] = round(time.time() - t0, 1)

    if config_sweep:
        seeds = sweep_seeds or [seed]
        tr = make("fairenergy")
        watch("before", "config_sweep", "fairenergy", None)
        outs = tr.run_sweep(seeds, rounds, eval_every=eval_every,
                            configs=config_sweep)
        watch("after", "config_sweep", "fairenergy", outs)
        acc, energy = outs["accuracy"], outs["energy"].sum(-1)  # [C, S, R]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            lanes = [{
                "config": {k: v[c] for k, v in outs["configs"].items()},
                "final_acc_mean": float(np.nanmean(acc[c, :, -1])),
                "final_acc_std": float(np.nanstd(acc[c, :, -1])),
                "energy_per_round_mean_J": float(energy[c].mean()),
                "mean_selected": float(outs["x"][c].sum(-1).mean()),
            } for c in range(acc.shape[0])]
        results["config_sweep"] = {"seeds": [int(s) for s in seeds],
                                   "lanes": lanes}
        results["elapsed_s"] = round(time.time() - t0, 1)
    return results


def _json_safe(obj):
    """NaN -> null (eval_every-skipped rounds): bare NaN is not JSON."""
    if isinstance(obj, float) and np.isnan(obj):
        return None
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_json_safe(v) for v in obj]
    return obj


def main(out=DEFAULT_OUT, write=True, **kw):
    """``run_all(**kw)``, its JSON written to ``out``, and the summary
    (``write=False``: neither, as on the ranks other than 0)."""
    if os.path.abspath(out).endswith(os.path.normpath(PROTECTED_OUT)):
        raise ValueError(f"{PROTECTED_OUT} is the JAX package's recorded "
                         "example; write elsewhere")
    res = run_all(**kw)
    if write:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(_json_safe(res), f, indent=1)
        summarize(res)
    return res


def _sharded_main(kw: dict, dev: torch.device):
    """``main`` on a ``clients`` mesh over the current process group, this
    rank on ``dev``."""
    rank = dist.get_rank()
    if rank == 0:
        print(f"sharding the client axis over {dist.get_world_size()} ranks")
    return main(**dict(kw, device=dev, mesh=make_clients_mesh(device=dev),
                       write=rank == 0,
                       verbose=rank == 0 and kw.get("verbose", True)))


def _rank(rank: int, world: int, kw: dict, init: str,
          local_rank: Optional[int] = None):
    """One rank: its card (``local_rank``, by default ``rank``), a process
    group through ``init``, ``main`` on the mesh, the group torn down."""
    dev = rank_device(kw.get("device"), rank if local_rank is None else local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init, rank=rank, world_size=world)
    try:
        return _sharded_main(kw, dev)
    finally:
        dist.destroy_process_group()


def sharded(**kw):
    """``--shard-clients``: run ``main`` with one rank a card. Inside a
    process group the caller made, on it, each rank on its current card
    (returns this rank's results); under ``torchrun``, in the group it
    describes; otherwise on one spawned rank per visible card (one gloo
    rank on the CPU), returning rank 0's JSON as written."""
    if dist.is_initialized():
        # the caller has set this rank's card as the current device
        dev = resolve_device(kw.get("device"))
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return _sharded_main(kw, dev)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:     # torchrun
        return _rank(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                     kw, "env://", int(os.environ.get("LOCAL_RANK", 0)))
    dev = resolve_device(kw.get("device"))
    world = torch.cuda.device_count() if dev.type == "cuda" else 1
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'store')}"
        if world == 1:
            return _rank(0, 1, kw, init)
        torch.multiprocessing.spawn(_rank, args=(world, kw, init),
                                    nprocs=world, join=True)
    with open(kw.get("out", DEFAULT_OUT)) as f:
        return json.load(f)


def summarize(res):
    """The reference's summary table."""
    scn = res.get("scenario")
    print(f"\n=== FL results (N={res['n_clients']}, {res['rounds']} rounds, "
          f"K={res['k']}{', scenario=' + scn if scn else ''}) ===")
    print(f"{'strategy':14s}{'final_acc':>10s}{'E/round mJ':>12s}"
          f"{'E->80% J':>12s}{'part min/max/std':>20s}")
    for name, s in res["strategies"].items():
        acc = s["accuracy"][-1]
        epr = np.mean(s["energy_per_round_J"]) * 1e3
        e2t = s["energy_to_target_J"]
        p = s["participation"]
        print(f"{name:14s}{acc:10.3f}{epr:12.3f}"
              f"{(f'{e2t:.3f}' if e2t else 'n/a'):>12s}"
              f"{p['min']:>8d}/{p['max']:<4d}{p['std']:6.2f}")
        if "n_faulted" in s:
            print(f"{'':14s}faults: {s['n_faulted']} injected, "
                  f"{s['n_rejected']} rejected, clip "
                  f"{s['mean_clip_frac']:.2f}, "
                  f"{s['n_fallback_rounds']} solver-fallback rounds")
        if "n_retx" in s:
            print(f"{'':14s}link: {s['n_retx']} retx, {s['n_outage']} "
                  f"outages, goodput {s['mean_goodput_frac']:.2f}, "
                  f"retx energy {s['e_retx_J']*1e3:.3f} mJ")
        if "mean_bits" in s:
            print(f"{'':14s}quantized: mean width "
                  f"{s['mean_bits']:.1f} bits, "
                  f"{s['e_saved_J']*1e3:.3f} mJ saved vs 32-bit payloads")
    fe = res["strategies"]["fairenergy"].get("energy_to_target_J")
    for base in ("scoremax", "ecorandom"):
        bt = res["strategies"].get(base, {}).get("energy_to_target_J")
        if fe and bt:
            print(f"FairEnergy uses {100 * (1 - fe / bt):.0f}% less energy than "
                  f"{base} to reach target (paper: 71% vs ScoreMax, 79% vs EcoRandom)")
    if "sweep" in res:
        sw = res["sweep"]
        print(f"\n--- {len(sw['seeds'])}-seed sweep ---")
        for name, s in sw["strategies"].items():
            print(f"{name:14s} final acc {s['final_acc_mean']:.3f} "
                  f"± {s['final_acc_std']:.3f}   E/round "
                  f"{s['energy_per_round_mean_J']*1e3:.3f} "
                  f"± {s['energy_per_round_std_J']*1e3:.3f} mJ")
    if "config_sweep" in res:
        cs = res["config_sweep"]
        print(f"\n--- fairenergy config sweep ({len(cs['lanes'])} lanes x "
              f"{len(cs['seeds'])} seeds) ---")
        for ln in cs["lanes"]:
            knobs = " ".join(f"{k}={v:.3g}" for k, v in ln["config"].items())
            print(f"{knobs:40s} acc {ln['final_acc_mean']:.3f} "
                  f"± {ln['final_acc_std']:.3f}  E/round "
                  f"{ln['energy_per_round_mean_J']*1e3:.3f} mJ  "
                  f"sel {ln['mean_selected']:.1f}")


def crossed_lanes(swept: dict) -> Optional[dict]:
    """``{"eta": [a, b], "rho": [c]}`` crossed into flat config lanes in
    ``itertools.product`` order (None when nothing is swept)."""
    if not swept:
        return None
    keys = list(swept)
    lanes = list(itertools.product(*(swept[k] for k in keys)))
    return {k: [ln[i] for ln in lanes] for i, k in enumerate(keys)}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clients", "--n-clients", dest="clients", type=int,
                    default=20, help="number of FL clients N")
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--paper", action="store_true",
                    help="full paper scale: N=50, 150 rounds")
    ap.add_argument("--extra-baselines", action="store_true")
    ap.add_argument("--seeds", type=int, default=0,
                    help="N>0: an N-seed sweep per strategy (error bars)")
    ap.add_argument("--eval-every", type=int, default=1,
                    help="accuracy-eval stride")
    ap.add_argument("--sweep-eta", default=None,
                    help="comma-separated eta values: fairenergy config lanes "
                         "(crossed with --sweep-rho/--sweep-btot)")
    ap.add_argument("--sweep-rho", default=None,
                    help="comma-separated rho values (see --sweep-eta)")
    ap.add_argument("--sweep-btot", default=None,
                    help="comma-separated B_tot values in Hz (see --sweep-eta)")
    ap.add_argument("--scenario", default=None, choices=available_scenarios(),
                    help="named scenario preset (repro_torch.scenarios)")
    ap.add_argument("--max-retx", type=int, default=None,
                    help="HARQ retransmission budget a round (lossy uplink)")
    ap.add_argument("--burst-p", type=float, default=None,
                    help="Gilbert-Elliott quiet->burst probability a round")
    ap.add_argument("--price-outage", action="store_true", default=None,
                    help="price the expected attempt count in the solver")
    ap.add_argument("--bits-grid", default=None,
                    help="comma-separated quantization widths, e.g. 8,16,32")
    ap.add_argument("--deadline", type=float, default=None,
                    help="round deadline T_round in seconds: selected "
                         "clients past it are dropped from the aggregate; "
                         "overrides the scenario's preset deadline")
    ap.add_argument("--staleness-a", type=float, default=None,
                    help="staleness decay exponent a in w(tau)=(1+tau)^-a "
                         "(with a scenario that buffers late updates)")
    ap.add_argument("--fault-rate", type=float, default=None,
                    help="payload corruption rate; overrides the scenario "
                         "preset's corrupt_rate")
    ap.add_argument("--crash-rate", type=float, default=None,
                    help="mid-round crash rate; overrides the scenario "
                         "preset's crash_rate")
    ap.add_argument("--churn", type=float, default=None,
                    help="open-population away probability on 4-round "
                         "dwell epochs (scenario-less runs)")
    ap.add_argument("--defense", action="store_true", default=None,
                    help="defended aggregation (finite screen + norm "
                         "clipping); overrides the scenario preset")
    ap.add_argument("--clusters", type=int, default=None,
                    help="hierarchical control (core.hierarchy): k-means "
                         "client clusters for stratified candidate "
                         "sampling; 1 (default) keeps full-population "
                         "control")
    ap.add_argument("--pool-frac", type=float, default=None,
                    help="per-round candidate pool fraction sampled prop. "
                         "to fairness deficit; controllers solve on the "
                         "pooled slice only (1.0 = full population)")
    ap.add_argument("--mobility-sigma", type=float, default=None,
                    help="slow pathloss drift RMS in dB "
                         "(core.channel.MobilityConfig); overrides the "
                         "scenario preset (0 disables)")
    ap.add_argument("--shard-clients", action="store_true",
                    help="shard the client axis over a `clients` mesh, one "
                         "rank a visible card (or the ranks of the process "
                         "group it runs in); N is ghost-padded to the mesh")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' for the CPU)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    return ap.parse_args(argv)


def cli(argv=None) -> dict:
    a = parse_args(argv)
    swept = {"eta": a.sweep_eta, "rho": a.sweep_rho, "b_tot": a.sweep_btot}
    config_sweep = crossed_lanes({k: [float(x) for x in v.split(",")]
                                  for k, v in swept.items() if v})
    if config_sweep:
        print(f"config sweep: {len(next(iter(config_sweep.values())))} lanes "
              f"over {list(config_sweep)}")
    kw = dict(out=a.out, extra_baselines=a.extra_baselines,
              eval_every=a.eval_every, scenario=a.scenario,
              deadline=a.deadline, staleness_a=a.staleness_a,
              fault_rate=a.fault_rate, crash_rate=a.crash_rate,
              churn=a.churn, defense=a.defense, clusters=a.clusters,
              pool_frac=a.pool_frac, mobility_sigma=a.mobility_sigma,
              max_retx=a.max_retx, burst_p=a.burst_p,
              price_outage=a.price_outage,
              bits_grid=([float(b) for b in a.bits_grid.split(",")]
                         if a.bits_grid else None),
              sweep_seeds=list(range(a.seeds)) if a.seeds else None,
              config_sweep=config_sweep, device=a.device)
    if a.paper:
        kw.update(n_clients=50, rounds=150)
    else:
        kw.update(n_clients=a.clients, rounds=a.rounds)
    return sharded(**kw) if a.shard_clients else main(**kw)


if __name__ == "__main__":
    cli()
