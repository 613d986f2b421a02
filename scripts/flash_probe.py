#!/usr/bin/env python3
"""Probe the flash kernels on the card: build the library, print ptxas's
registers and spills for the units of the chosen type, hold every route of
that type against the plain version at the head dims below, each at a
causal GQA call, a window with a ragged S, a non-causal call with Skv !=
Sq and a window past Skv (rows that see no key; ``--wide-cases``:
chip_smoke's ``WIDE_CASES`` instead, ``--seed``: the inputs' generator),
listing every failing case (out within ``chip_smoke.FLASH_ATOL``, lse
within ``FLASH_LSE_ATOL``, out the same with and without lse, two
launches of the right route; also the kernel's and the plain version's
distances to float64), then time the kernel beside SDPA.
fp32 (the default) goes by ``ops.f32_route`` (SIMT up to 128, 3xTF32 to
256, its clusters to 2,048, the split route above) and is timed at
Gemma-7B's call, at ``[4, 2048, 32 | 4, D]`` and at phase 11's train
shape; bf16 and fp16 (``--dtype``) go by ``ops.sm90_route`` (one CTA a
query tile up to 256, the wide kernel to 320, the cluster kernel to 1,792,
the split route above) and are timed at ``[4, 2048, 32 | 4, D]`` for the
head dims past 256 checked. ``--split`` checks the split route
(``ops.flash_attention_split_cuda``) at every head dim given instead, and
times it at ``[4, 2048, 32 | 4, D]`` beside the route that takes D (at the
clusters' top dims, the cluster) in turns: route, split, split, route.

    python3 scripts/flash_probe.py                 # every fp32 head dim below
    python3 scripts/flash_probe.py 160,256,1024    # these head dims
    python3 scripts/flash_probe.py 160 --no-time   # checks only
    python3 scripts/flash_probe.py 256 --smoke     # and the smoke TinyLlama
                                                   # at head_dim 256 and 512
                                                   # card against CPU in fp32
                                                   # (phases 15 and 17 (c))
    python3 scripts/flash_probe.py --dtype bfloat16 264,512,1024,1792,1800
    python3 scripts/flash_probe.py --split 1024,2048,2056,4104
    python3 scripts/flash_probe.py --dtype bfloat16 --split 1024,1792,1800,3600
    python3 scripts/flash_probe.py 4104 --wide-cases --seed 43 --no-time
                        # chip_smoke's phase 17 (a) calls at D = 4,104, the
                        # same inputs (its generator's seed for that D);
                        # --no-ptxas skips the units' ptxas lines
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DIMS = (64, 132, 160, 164, 192, 224, 256, 264, 300, 320, 384, 512, 1024,
        2048, 2056, 4104)
DIMS_16 = (64, 256, 264, 300, 320, 384, 512, 1000, 1024, 1792, 1800, 3600)
# the units of each type's kernels, whose ptxas lines are printed
UNITS = {"float32": ("flash_attention_tf32.cu", "flash_attention_tf32_wide.cu",
                     "flash_attention_split.cu"),
         "bfloat16": ("flash_attention_sm90_wide.cu", "flash_attention_split.cu"),
         "float16": ("flash_attention_sm90_wide.cu", "flash_attention_split.cu")}
CASES = ((1, 600, 8, 2, True, None, None),        # B, S, H, KV, causal, window, Skv
         (2, 333, 4, 4, True, 100, None),
         (1, 200, 4, 1, False, None, 150),
         (1, 300, 4, 2, False, 20, 150))          # rows 169.. see no key
# label -> (B, S, H, KV, D, dtype); the train shape of phase 11 in both types
TIMED = {"gemma_7b": (2, 2048, 16, 16, 256, "float32"),
         "d160": (2, 2048, 16, 16, 160, "float32"),
         "d512": (4, 2048, 32, 4, 512, "float32"),
         "d1024": (4, 2048, 32, 4, 1024, "float32"),
         "train_bf16": (4, 4096, 32, 4, 64, "bfloat16"),
         "train_f32": (4, 4096, 32, 4, 64, "float32")}


def ptxas_lines(_build, dtype: str) -> None:
    keys = ("tf32", "split") if dtype == "float32" else ("sm90", "split")
    for f in UNITS[dtype]:
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                            "-c", str(ROOT / "src/repro_torch/csrc" / f),
                            "-o", str(_build.BUILD_DIR / f"{f}.probe.o")],
                           capture_output=True, text=True)
        name = None
        for line in (r.stdout + r.stderr).splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
            elif "Used" in line and name and any(key in name for key in keys):
                print(f, name[:70], line.strip()[-90:], flush=True)
            elif "spill" in line and name and any(key in name for key in keys):
                print(f, name[:70], line.strip(), flush=True)


def _f64(torch, q, k, v, causal, window=None):
    """Softmax attention of q, k, v in float64, masked scores -1e30 (a row
    with no visible key is the mean of V, as in the plain version)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qd, kd, vd = (t.double().transpose(1, 2) for t in (q, k, v))
    kd, vd = (t.repeat_interleave(H // KV, dim=1) for t in (kd, vd))
    s = qd @ kd.transpose(-1, -2) / D ** 0.5
    rows = torch.arange(Sq, device=q.device)[:, None]
    keys = torch.arange(Skv, device=q.device)[None, :]
    vis = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device)
    if causal:
        vis &= keys <= rows
    if window:
        vis &= rows - keys < window
    s = s.masked_fill(~vis, -1e30)
    return (torch.softmax(s, dim=-1) @ vd).transpose(1, 2)


def route_counter(ops, torch, dt, D, split=False) -> str:
    """The launch counter of the route that takes head dim D in ``dt`` (with
    ``split``, the split route's)."""
    if split:
        return (ops.F32_ROUTE_COUNTERS["tf32_split"] if dt == torch.float32
                else ops.SM90_ROUTE_COUNTERS["sm90_split"])
    return ops.route_counter(dt, -(-D // ops.ROW_MULTIPLE[dt]) * ops.ROW_MULTIPLE[dt])


def check(cs, ops, ref, torch, dev, dims, dt, split=False, seed=3, cases=CASES) -> list:
    fa = ops.flash_attention
    run = ops.flash_attention_split_cuda if split else ops.flash_attention_cuda
    fails = []
    gen = torch.Generator(device=dev).manual_seed(seed)
    for D in dims:
        route = route_counter(ops, torch, dt, D, split)
        for B, S, H, KV, causal, window, Skv in cases:
            Skv = Skv or S
            case = [B, S, H, KV, D, causal, window, Skv]
            try:
                q = torch.randn(B, S, H, D, device=dev, generator=gen).to(dt)
                k = torch.randn(B, Skv, KV, D, device=dev, generator=gen).to(dt)
                v = torch.randn(B, Skv, KV, D, device=dev, generator=gen).to(dt)
                before = getattr(fa, route)
                got = run(q, k, v, causal=causal, window=window)
                got_l, lse = run(q, k, v, causal=causal, window=window, with_lse=True)
                want = ref.attention_ref(q, k, v, causal=causal, window=window)
                _, lse_want = ref.flash_fwd_ref(q, k, v, causal=causal, window=window)
                torch.cuda.synchronize()
                e = float((got.float() - want.float()).abs().max())
                e_lse = float((lse - lse_want).abs().max())
                # both sides' distance to softmax attention in float64
                exact = _f64(torch, q, k, v, causal, window)
                far = {"kernel_vs_f64": float((got.double() - exact).abs().max()),
                       "plain_vs_f64": float((want.double() - exact).abs().max())}
                del exact
                ok = (e <= cs.FLASH_ATOL[dt] and e_lse <= cs.FLASH_LSE_ATOL[dt]
                      and torch.equal(got, got_l) and getattr(fa, route) - before == 2)
                print(json.dumps({"case": case, "route": route, "max_abs_err": e,
                                  "lse_max_abs_err": e_lse, **far, "ok": ok}), flush=True)
                if not ok:
                    fails.append(case)
            except Exception:
                fails.append(case)
                traceback.print_exc()
                torch.cuda.synchronize()
        print(json.dumps({"D": D, "attributes": ops.kernel_attributes(dt, D)}),
              flush=True)
    return fails


def timed_split(cs, ops, torch, dev, dt, dims) -> None:
    """The split route beside the route that takes D at [4, 2048, 32 | 4,
    D], route, split, split, route (CUDA events, 5 calls each after 1)."""
    for D in dims:
        gen = torch.Generator(device=dev).manual_seed(D)
        q, k, v = (torch.randn(4, 2048, n, D, device=dev, generator=gen).to(dt)
                   for n in (32, 4, 4))
        fns = {"route": lambda: ops.flash_attention_cuda(q, k, v, causal=True),
               "split": lambda: ops.flash_attention_split_cuda(q, k, v, causal=True)}
        ms = {"route": [], "split": []}
        for name in ("route", "split", "split", "route"):
            ms[name].append(cs.cuda_ms(fns[name], 5, warmup=1))
        Dp = -(-D // ops.ROW_MULTIPLE[dt]) * ops.ROW_MULTIPLE[dt]
        print(json.dumps({"timed_split": D, "dtype": str(dt), "route": ops.route_of(dt, Dp),
                          "route_ms": ms["route"], "split_ms": ms["split"],
                          "pieces": len(ops.split_pieces(4, 32, 2048, 2048)),
                          "bound_ms": cs.flash_fwd_bound(
                              q, k, cs.PEAK_3XTF32_S if dt == torch.float32
                              else cs.PEAK[dt])[0]}), flush=True)
        del q, k, v


def timed(cs, torch, dev, dt, dims) -> None:
    runs = (TIMED if dt == torch.float32 else
            {f"d{D}": (4, 2048, 32, 4, D, str(dt)[6:]) for D in dims if D > 256})
    for label, (B, S, H, KV, D, dtype) in runs.items():
        dt = getattr(torch, dtype)
        gen = torch.Generator(device=dev).manual_seed(D)
        q, k, v = (torch.randn(B, S, n, D, device=dev, generator=gen).to(dt)
                   for n in (H, KV, KV))
        res = cs.time_flash(q, k, v, cs.PEAK[dt], iters=5 if D > 256 else 20)
        print(json.dumps({"timed": label, "dtype": dtype, **{k: res[k] for k in (
            "ms", "ms_with_lse", "library_ms", "sdpa_backend", "bound_ms")}}),
            flush=True)
        del q, k, v


def smoke_models(cs, torch, dev) -> None:
    """The fp32 halves of chip_smoke's phases 15 and 17 (c): the smoke
    TinyLlama at head_dim 256 (two layers) and 512 (one) card against CPU,
    a 2,048-token prefill and serve steps, then 3 train steps (their
    gates)."""
    import dataclasses

    from repro_torch.configs import get_smoke
    for head_dim, layers, flat in ((256, None, None), (512, 1, 1e-5)):
        cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), head_dim=head_dim,
                                  **({"n_layers": layers} if layers else {}))
        cs.family13_card_against_cpu(dev, "tinyllama-1.1b", "float32", cfg=cfg,
                                     label=f"probe D={head_dim}")
        cs.family13_train_card_against_cpu(dev, "tinyllama-1.1b",
                                           cs.FAMILY13_SMOKE["prompt"], cfg.n_layers,
                                           label=f"probe D={head_dim}",
                                           flat_gate=flat, cfg=cfg)


def main(argv) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    t0 = time.time()
    _build.library()
    print("build_s", round(time.time() - t0, 1), flush=True)
    dtype = argv[argv.index("--dtype") + 1] if "--dtype" in argv else "float32"
    dt = getattr(torch, dtype)
    if "--no-ptxas" not in argv:
        ptxas_lines(_build, dtype)
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import ops, ref
    dev = torch.device("cuda")
    args = [a for i, a in enumerate(argv)
            if not a.startswith("--") and (i == 0 or argv[i - 1] not in ("--dtype", "--seed"))]
    dims = ([int(a) for a in args[0].split(",")] if args
            else DIMS if dt == torch.float32 else DIMS_16)
    split = "--split" in argv
    seed = int(argv[argv.index("--seed") + 1]) if "--seed" in argv else 3
    cases = cs.WIDE_CASES if "--wide-cases" in argv else CASES
    fails = check(cs, ops, ref, torch, dev, dims, dt, split, seed, cases)
    print("FAILS", fails, flush=True)
    if "--smoke" in argv:
        smoke_models(cs, torch, dev)
    if "--no-time" not in argv:
        if split:
            timed_split(cs, ops, torch, dev, dt, dims)
        else:
            timed(cs, torch, dev, dt, dims)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
