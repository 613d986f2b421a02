#!/usr/bin/env python3
"""Check and time the bf16 flash kernel past a head dim of 256 for several
source trees in turn on one card: each tree (a ``src`` directory holding
``repro_torch``, e.g. a variant of ``csrc/flash_sm90.cuh`` unpacked under
``build/``) runs in a process of its own, which builds and loads its own
library, holds the kernel against the plain version (three calls a head
dim: causal GQA, a window with a ragged S, non-causal with Skv != Sq) and
times it at ``[4, 2048, 32 | 4, D]`` causal (CUDA events, 5 calls after 2).
One JSON line a tree; list a tree twice (A B B A) to see the spread.

    python3 scripts/flash16_variants.py build/v1/src build/v2/src
    python3 scripts/flash16_variants.py src build/parent/src --dims 512,1024
"""
from __future__ import annotations

import json
import subprocess
import sys

DIMS = (224, 264, 512, 1024, 1792)
CHECKED = (264, 512, 1024, 1792)
CASES = ((1, 600, 8, 2, True, None, None),      # B, S, H, KV, causal, window, Skv
         (2, 333, 4, 4, True, 100, None),
         (1, 200, 4, 1, False, None, 150))


def one_tree(src: str, dims) -> dict:
    sys.path.insert(0, src)
    import torch

    from repro_torch.kernels.flash_attention import ops, ref
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(3)
    worst = 0.0
    for D in CHECKED:
        for B, S, H, KV, causal, window, Skv in CASES:
            Skv = Skv or S
            q = torch.randn(B, S, H, D, device=dev, generator=gen).bfloat16()
            k = torch.randn(B, Skv, KV, D, device=dev, generator=gen).bfloat16()
            v = torch.randn(B, Skv, KV, D, device=dev, generator=gen).bfloat16()
            got = ops.flash_attention_cuda(q, k, v, causal=causal, window=window)
            want = ref.attention_ref(q, k, v, causal=causal, window=window)
            worst = max(worst, float((got.float() - want.float()).abs().max()))
    out = {"src": src, "max_abs_err": worst}
    for D in dims:
        g = torch.Generator(device=dev).manual_seed(D)
        q, k, v = (torch.randn(4, 2048, n, D, device=dev, generator=g).bfloat16()
                   for n in (32, 4, 4))
        call = lambda: ops.flash_attention_cuda(q, k, v, causal=True)  # noqa: E731
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(5):
            call()
        b.record()
        torch.cuda.synchronize()
        out[f"bfloat16_{D}_ms"] = a.elapsed_time(b) / 5
    return out


def main(argv) -> int:
    dims = DIMS
    if "--dims" in argv:
        i = argv.index("--dims")
        dims = tuple(int(d) for d in argv[i + 1].split(","))
        argv = argv[:i] + argv[i + 2:]
    if argv and argv[0] == "--one":
        print(json.dumps(one_tree(argv[1], dims)), flush=True)
        return 0
    for src in argv:
        res = subprocess.run([sys.executable, __file__, "--one", src,
                              "--dims", ",".join(map(str, dims))],
                             capture_output=True, text=True)
        print(res.stdout.strip().splitlines()[-1] if res.returncode == 0
              else json.dumps({"src": src, "failed": res.stderr[-2000:]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
