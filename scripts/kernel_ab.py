#!/usr/bin/env python3
"""Time the port's flash, fused dual-ascent and block top-k kernels of two
checkouts in turns on one card: ``--compare A B`` runs A, B, B, A (one
process each, so each builds and loads its own ``libkernels.so``) and
prints every run's times and the medians by checkout.

    python3 scripts/kernel_ab.py --compare build/parent/src src
    python3 scripts/kernel_ab.py --src src          # one run, one JSON line
    python3 scripts/kernel_ab.py --compare build/parent/src src --only flash16
                                       # the 16-bit flash past 256 alone
    python3 scripts/kernel_ab.py --compare build/parent/src src --only split
                                       # the head dims past the clusters alone

Times are CUDA events around back-to-back launches (flash: 20 after 3
warm-up calls; 5 after 1 past a head dim of 256) and the profiler's device
time of the fused ascent (20 launches), at the shapes of chip_smoke.py's
phases 2 and 17: flash at the serve shape, zamba2's D = 80, phi-3-vision's
D = 96 and the train shape, in bf16 and fp32, the serve shape in fp16; in
fp32 also the head dims of phase 2's ``FLASH_HEAD_DIMS`` past 128 (160,
192, 224 at ``[2, 2048, 16 | 16, D]``, Gemma-2B's and Gemma-7B's calls)
and phase 17's ``WIDE_DIMS`` at ``[4, 2048, 32 | 4, D]``; bf16 and fp16 at
``WIDE_DIMS`` and at the edges of the 16-bit cluster kernel's reach
(``SM90_EDGE_DIMS``: 1,792 on the cluster, 1,800 and 3,600 past it) at
that shape; the head dims past both clusters' reach (``FLASH_SPLIT``: fp32
2,056 and 4,104, bf16 and fp16 1,800 and 3,600, the split route since it
came); the ascent on the paper's 10 gammas (L = 10) and x (8, 16, 32)
(L = 30) at N = 50; both top-k kernels at block widths ``TOPK_WIDTHS``, the
rows kernel on phase 2's ``[50, 1,630,090]`` matrix at ks of the gamma
grid, the block kernel on one row at gamma 0.25: the profiler's device time
of a call's launches (``topk_*_ms``, over 5 and 10 calls), the mean of one
launch (``topk_*_launch_ms``) and the launches it saw a call.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys

FLASH = {"serve_d64": (4, 2048, 32, 4, 64), "zamba2_d80": (4, 2048, 32, 32, 80),
         "phi3v_d96": (2, 2048, 32, 32, 96), "train_d64": (4, 4096, 32, 4, 64)}
# fp32 alone: the head dims the 3xTF32 kernel takes
FLASH_F32 = {"d160": (2, 2048, 16, 16, 160), "d192": (2, 2048, 16, 16, 192),
             "d224": (2, 2048, 16, 16, 224), "gemma_2b": (4, 2048, 8, 1, 256),
             "gemma_7b": (2, 2048, 16, 16, 256),
             **{f"wide_d{D}": (4, 2048, 32, 4, D)
                for D in (264, 288, 300, 320, 384, 512, 1024)}}
# bf16 and fp16 past 256: phase 17's WIDE_DIMS and the cluster's reach
FLASH_16_WIDE = {f"wide_d{D}": (4, 2048, 32, 4, D)
                 for D in (264, 288, 300, 320, 384, 512, 1024, 1792)}
# past both clusters' reach: (label, shape, dtype)
FLASH_SPLIT = [(f"wide_d{D}", (4, 2048, 32, 4, D), dt)
               for dts, dims in ((("float32",), (2056, 4104)),
                                 (("bfloat16", "float16"), (1800, 3600)))
               for D in dims for dt in dts]
GRID = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)
TOPK_WIDTHS = (1, 100, 4096, 8192, 65536, 1_630_090)


def one_run(src: str, only: str | None = None) -> dict:
    sys.path.insert(0, src)
    import torch

    from repro_torch.kernels.dual_solve import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    dev = torch.device("cuda:0")

    def events_ms(fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    def profiled(fn, kernel, iters):
        """(device ms of the launches seen, launches seen) of the kernels
        whose name holds ``kernel`` over ``iters`` calls."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if kernel in e.key]
        return (sum(e.self_device_time_total for e in ev) / 1e3,
                sum(e.count for e in ev))

    def device_ms(fn, kernel, iters=20):
        ms, count = profiled(fn, kernel, iters)
        return ms / count

    out = {}
    gen = torch.Generator(device=dev).manual_seed(0)
    runs = [(label, shape, getattr(torch, dt)) for label, shape, dt in FLASH_SPLIT
            if only != "flash16" or dt != "float32"]
    if only != "split":
        runs += [(label, shape, dt) for label, shape in FLASH_16_WIDE.items()
                 for dt in (torch.bfloat16, torch.float16)]
    if only is None:
        runs += [(label, shape, dt) for label, shape in FLASH.items()
                 for dt in (torch.bfloat16, torch.float32)]
        runs += [("serve_d64", FLASH["serve_d64"], torch.float16)]
        runs += [(label, shape, torch.float32) for label, shape in FLASH_F32.items()]
    for label, (B, S, H, KV, D), dt in runs:
        q, k, v = (torch.randn(B, S, n, D, device=dev, generator=gen).to(dt)
                   for n in (H, KV, KV))
        iters = (20, 3) if D <= 256 else (5, 1)
        out[f"flash_{str(dt)[6:]}_{label}"] = events_ms(
            lambda: fops.flash_attention_cuda(q, k, v, causal=True), *iters)
        del q, k, v
    if only is not None:
        return out
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    g = torch.Generator().manual_seed(4)
    n = 50
    P = (1e-4 + 2e-4 * torch.rand(n, generator=g)).to(dev)
    h = (1e-3 * (50 + 450 * torch.rand(n, generator=g)) ** -3.0
         * torch.empty(n).exponential_(generator=g)).to(dev)
    u = (0.1 + 5.0 * torch.rand(n, generator=g)).to(dev)
    mu, q = torch.zeros(n, device=dev), torch.rand(n, generator=g).to(dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    for label, bits in (("L10", None), ("L30", (8.0, 16.0, 32.0))):
        kw = dict(gamma_grid=GRID, eta=f(1e-3), rho=f(0.5), pi_min=f(0.2),
                  alpha_lambda=f(2e-4), alpha_mu=f(0.1), dual_tol=f(0.0),
                  b_tot=f(1e7), s_bits=f(32 * 1_630_090.0), i_bits=f(1_630_090.0),
                  n0=f(4e-21), b_lo=f(1e-4), inner_iters=30, bits_grid=bits)
        out[f"ascent_{label}"] = device_ms(
            lambda: dops.dual_ascent(P, h, u, f(1e-4), mu, q, alive, **kw),
            "dual_ascent_kernel")
    from repro_torch.kernels.topk_sparsify import ops as tops
    mat = torch.randn(n, 1_630_090, device=dev, generator=gen) * 1e-3
    flat = mat[0].clone()
    for w in TOPK_WIDTHS:
        ks = torch.tensor([max(1, min(w, math.ceil(g * w))) for g in GRID],
                          dtype=torch.int32, device=dev)[torch.arange(n) % len(GRID)]
        for name, fn, iters in (
                ("rows", lambda: tops.block_topk_rows(mat, ks, block=w), 5),
                ("block", lambda: tops.block_topk_sparsify(flat, 0.25, block=w), 10)):
            ms, count = profiled(fn, f"topk_{name}", iters)
            out[f"topk_{name}_{w}_ms"] = ms / iters
            out[f"topk_{name}_{w}_launch_ms"] = ms / count
            out[f"topk_{name}_{w}_launches_seen_a_call"] = count / iters
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    ap.add_argument("--only", choices=("flash16", "split"),
                    help="time bf16 and fp16 past a head dim of 256 alone, "
                         "or the head dims past the clusters' reach alone")
    args = ap.parse_args(argv)
    if args.src:
        print(json.dumps(one_run(args.src, args.only)), flush=True)
        return 0
    a, b = args.compare
    runs = []
    for src in (a, b, b, a):
        res = subprocess.run([sys.executable, __file__, "--src", src,
                              *(["--only", args.only] if args.only else [])],
                             capture_output=True, text=True, check=True)
        line = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append((src, line))
        print(json.dumps({"src": src, "ms": line}), flush=True)
    for src in (a, b):
        got = [r for s, r in runs if s == src]
        print(json.dumps({"median_ms": src, **{k: statistics.median(r[k] for r in got)
                                               for k in got[0]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
