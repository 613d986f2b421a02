#!/usr/bin/env python3
"""The sampled decide with its pool drawn on the card (the port's
``core.hierarchy.sampling``) against the same draw made on the host, on
one NVIDIA GPU.

    python3 scripts/pool_draw_compare.py

The host variant brings the deficit, the cluster assignment and the alive
mask to the host, draws the Gumbel noise there by the port's threefry and
``log_xla`` and sorts there, and sends only the ``[K_pool]`` indices to
the card. For N in ``chip_smoke.DECIDE_N`` (50, 10^4, 10^5; pool 512,
clusters 8, the hierarchy bench's synthetic statistics) it first checks
that both draws give the same pools for 5 rounds, counts the device
activities (kernels and copies) of one card draw, then runs
``chip_smoke.decide_latency`` (ms a pooled and a full decide over 10
decides) twice a draw, alternating card and host. Prints one JSON line a
measurement, the card's name and power limit, and a summary line; exits
non-zero without a GPU or if the pools differ.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def host_sampling_weights(self, state, alive=None):
    """``SampledController.sampling_weights`` computed on the host."""
    from repro_torch.core.hierarchy.sampling import deficit_weights
    if hasattr(self.inner, "sampling_deficit"):
        deficit = self.inner.sampling_deficit(state.inner).cpu()
    else:
        deficit = torch.zeros(self.n_clients, dtype=torch.float32)
    w = deficit_weights(deficit, state.assign.cpu(), self.cfg.clusters,
                        self.cfg.deficit_floor)
    if alive is not None:
        w = torch.where(alive.cpu(), w, 0.0)
    return w


def host_pool_for(self, state, round_idx, alive=None):
    """``SampledController.pool_for`` drawn on the host; the indices go to
    the state's device."""
    from repro_torch.core.hierarchy.sampling import pool_indices
    w = host_sampling_weights(self, state, alive)
    return pool_indices(state.key.cpu(), round_idx, w, self.k_pool).to(
        state.assign.device)


def wrapped(dev, n: int):
    """``decide_latency``'s pooled controller and its initial state."""
    from repro_torch import random as prng
    from repro_torch.configs import FairEnergyConfig
    from repro_torch.core.controllers import ControllerContext, make_controller
    from repro_torch.core.hierarchy import HierarchyConfig, wrap_controller
    import chip_smoke as cs
    rng = np.random.default_rng(0)
    ctx = ControllerContext(n_clients=n, b_tot=10e6, s_bits=6.4e7,
                            i_bits=2e6, n0=4e-21, device=dev,
                            fe_cfg=FairEnergyConfig(eta=1e-3, eta_auto=False))
    pathloss, power = rng.uniform(1e-9, 1e-7, n), rng.uniform(0.1, 1.0, n)
    cfg = HierarchyConfig(clusters=cs.DECIDE_CLUSTERS if n >= 64 else 1,
                          pool_size=min(cs.DECIDE_POOL, n))
    ctrl = wrap_controller(make_controller("fairenergy", ctx), cfg, ctx,
                           pathloss=pathloss, power=power,
                           base_key=prng.PRNGKey(17), seed=0)
    return ctrl, ctrl.init(n)


def device_kernels(fn) -> int:
    """Device activities (kernels and copies) that torch.profiler sees
    while ``fn()`` runs."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def main() -> int:
    if not torch.cuda.is_available():
        print("pool_draw_compare: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.core.hierarchy.sampling import SampledController
    from repro_torch.kernels import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    _build.library()
    card = SampledController.pool_for
    summary = {}
    for n in cs.DECIDE_N:
        ctrl, state = wrapped(dev, n)
        if not all(torch.equal(card(ctrl, state, r),
                               host_pool_for(ctrl, state, r))
                   for r in range(5)):
            print(f"pool_draw_compare: the draws differ at N = {n}",
                  file=sys.stderr)
            return 1
        row = summary.setdefault(n, {"card": [], "host": [], "full": []})
        row["card_draw_device_activities"] = device_kernels(
            lambda: card(ctrl, state, 5))
        for _ in range(2):
            for draw in ("card", "host"):
                SampledController.pool_for = (card if draw == "card"
                                              else host_pool_for)
                try:
                    res = cs.decide_latency(dev, n)
                finally:
                    SampledController.pool_for = card
                row[draw].append(res["pooled"]["ms_per_decide"])
                row["full"].append(res["full"]["ms_per_decide"])
    print(smi)
    print(json.dumps({"pooled_decide_ms_by_draw": summary,
                      "pools_equal": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
