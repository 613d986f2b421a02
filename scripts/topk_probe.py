#!/usr/bin/env python3
"""Probe the block top-k kernels on the card: build the library, print
ptxas's registers and spills for ``topk_rows.cu`` and ``topk_block.cu``,
hold every tier against the plain versions at edge widths listing every
failing case (``chip_smoke.py`` phase 16 stops at the first), then time
both kernels a call at 11 widths (the profiler's device time of a call's
launches, over 5 and 10 calls).

    python3 scripts/topk_probe.py                # every width below
    python3 scripts/topk_probe.py 17,100,8193    # these widths

The checks are phase 16's: the rows kernel (with and without the all-full
skip, the rows entry at literal ks) on phase 2's tricky rows and four
CNN-wide rows, the block kernel on them flattened in fp32, bf16 and fp16.
fp16 is held, as in phase 16, to the plain version itself, whose integer
widening keeps every NaN's payload wherever it falls (``ref.widen_f16``).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WIDTHS = (1, 2, 3, 16, 17, 31, 32, 33, 100, 128, 255, 256, 257, 4095, 4096,
          4097, 8191, 8192, 8193, 49151, 49152, 49153, 65535, 65536, 65537,
          98303, 98304, 98305, 1_630_090)
TIMED = (1, 2, 32, 100, 128, 255, 4096, 8192, 49152, 65536, 1_630_090)


def ptxas_lines(_build) -> None:
    for f in ("topk_rows.cu", "topk_block.cu"):
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                            "-c", str(ROOT / "src/repro_torch/csrc" / f),
                            "-o", str(_build.BUILD_DIR / f"{f}.probe.o")],
                           capture_output=True, text=True)
        name = None
        for line in (r.stdout + r.stderr).splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
            elif "Used" in line and name:
                print(f, name[:70], line.strip()[-90:])
            elif "spill" in line and name and "0 bytes spill" not in line:
                print(f, name[:70], "SPILL", line.strip())


def check(cs, ops, ref, torch, dev, widths) -> list:
    tricky, tks = cs._tricky_rows(dev)
    longr = cs._long_tricky(dev)
    t16 = tricky.flatten().bfloat16()
    t16.view(torch.int16)[5] = 0x7FFF
    th = tricky.flatten().half()
    th.view(torch.int16)[7] = 0x7FFF
    l16, lh = longr.flatten().bfloat16(), longr[1:3].flatten().half()
    fails = []
    for w in widths:
        t1 = time.time()
        try:
            sets = []
            if w <= 65536:
                sets.append(("tricky", tricky, cs._width_ks(tks, w)))
            if w >= 8192:
                sets.append(("long", longr, torch.tensor(
                    [max(1, w // 10), max(1, w // 2), w, max(1, w // 4)],
                    dtype=torch.int32, device=dev)))
            for what, m, ks in sets:
                for skip in (True, False):
                    got = ops.block_topk_rows(m, ks, block=w, skip_full=skip)
                    want = ref.block_topk_rows(m, ks, block=w, skip_full=skip)
                    if not cs.same_bits(got, want):
                        fails.append((w, what, "rows", skip))
                        print("FAIL rows", w, what, skip, cs.diff_report(got, want, ks)[:600])
                if not cs.same_bits(ops.block_topk_rows(m, torch.full_like(ks, w), block=w), m):
                    fails.append((w, what, "allfull"))
                n_r = min(m.numel() // w, 96)
                rows = m.reshape(-1)[:n_r * w].view(n_r, w)
                lit = torch.tensor([0, -3, 1, w, w + 7, max(1, w // 3)],
                                   dtype=torch.int32, device=dev)
                lit = lit[(torch.arange(n_r, device=dev) + 3) % len(lit)]
                got = ops.block_topk_sparsify_rows(rows, lit)
                want = ref.block_topk_sparsify_rows(rows, lit)
                if not cs.same_bits(got, want):
                    fails.append((w, what, "entry"))
                    print("FAIL entry", w, what, cs.diff_report(got, want, lit)[:600])
            vecs = [(tricky.flatten(), (0.1, 0.5, 1.0)), (t16, (0.1, 0.5)), (th, (0.1, 0.5))]
            if w >= 8192:
                vecs += [(longr.flatten(), (0.25,)), (l16, (0.25,)), (lh, (0.25,))]
            for v, gammas in vecs:
                for gamma in gammas:
                    got, k = ops.block_topk_sparsify(v, gamma, block=w)
                    ints = torch.int32 if v.dtype == torch.float32 else torch.int16
                    want, _ = ref.block_topk_ref(v, gamma, block=w)
                    gi, wi = got.cpu().view(ints), want.cpu().view(ints)
                    if torch.equal(gi, wi):
                        continue
                    bad = (gi != wi).nonzero().flatten()
                    fails.append((w, "block", str(v.dtype), gamma))
                    print("FAIL block", w, v.dtype, v.numel(), gamma, k,
                          bad[:10].tolist(), len(bad))
                    vi = v.cpu().view(ints)
                    for blk in sorted(set((bad // w).tolist()))[:3]:
                        s0, s1 = blk * w, min((blk + 1) * w, v.numel())
                        gk, wk = (gi[s0:s1] != 0), (wi[s0:s1] != 0)
                        mag = v.cpu()[s0:s1].float().abs()
                        print("  block", blk, "kept got/want", int(gk.sum()), int(wk.sum()),
                              "min kept got/want", float(mag[gk].min()) if gk.any() else None,
                              float(mag[wk].min()) if wk.any() else None,
                              "nan", int(torch.isnan(mag).sum()), "zeros", int((mag == 0).sum()))
                        for e in bad[(bad >= s0) & (bad < s1)][:6].tolist():
                            print("   lane", e, "in", hex(int(vi[e])), "got", hex(int(gi[e])),
                                  "want", hex(int(wi[e])))
            torch.cuda.synchronize()
            print(json.dumps({"w": w, "s": round(time.time() - t1, 2),
                              "rows": ops.kernel_attributes("rows", block=w),
                              "block16": ops.kernel_attributes("block", torch.bfloat16, block=w)}),
                  flush=True)
        except Exception:
            fails.append((w, "exception"))
            traceback.print_exc()
            torch.cuda.synchronize()
    return fails


def per_call(torch, fn, key, iters=5):
    """(device ms of a call's launches, launches seen a call) of the
    kernels whose name holds ``key`` over ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if key in e.key]
    return (sum(e.self_device_time_total for e in ev) / 1e3 / iters,
            sum(e.count for e in ev) / iters)


def main(argv) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("topk_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    t0 = time.time()
    _build.library()
    print("build_s", round(time.time() - t0, 1), flush=True)
    ptxas_lines(_build)
    import chip_smoke as cs
    from repro_torch.kernels.topk_sparsify import ops, ref
    dev = torch.device("cuda")
    widths = [int(a) for a in argv[0].split(",")] if argv else WIDTHS
    fails = check(cs, ops, ref, torch, dev, widths)
    print("FAILS", fails, flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    mat = torch.randn(50, 1_630_090, device=dev, generator=gen) * 1e-3
    flat = mat[0].clone()
    gammas = torch.tensor([0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 0.01])
    for w in TIMED:
        ks = torch.clamp(torch.ceil(gammas[torch.arange(50) % 11] * w), 1, w).int().to(dev)
        r = per_call(torch, lambda: ops.block_topk_rows(mat, ks, block=w), "topk_rows")
        b = per_call(torch, lambda: ops.block_topk_sparsify(flat, 0.25, block=w),
                     "topk_block", 10)
        print(json.dumps({"time_w": w, "rows_ms": r[0], "rows_launches": r[1],
                          "block_ms": b[0], "block_launches": b[1]}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
