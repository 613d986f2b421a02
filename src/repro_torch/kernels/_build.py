"""Build and load the port's CUDA kernels (``csrc/*.cu``) on first use.

Each source compiles with its own ``nvcc`` (all started together) into an
object, and the objects link into one shared library with a plain C
interface, ``build/repro_torch/libkernels.so`` under the checkout root,
loaded with ``ctypes``. A stamp beside the library holds a hash of the
sources, the ``*.cuh`` headers they include and the flags, so a stale
build is redone and a current one reused.

Flags: ``sm_90a`` (Hopper: ``wgmma`` and ``setmaxnreg`` exist only for
that target), ``-O3``, precise math (no ``--use_fast_math``) and
``--fmad=false``: the dual-solve kernels must round every multiply and
add as the plain PyTorch version's separate elementwise ops do, or
near-tied argmins and selection tests could flip. The fp32 SIMT flash
kernel asks for its fused multiply-adds explicitly (``fmaf``); the 3xTF32
one and the bf16 and fp16 ones multiply on the tensor cores (the latter
two take their exponentials from ``ex2.approx``). The TMA tensor maps are encoded through the runtime's
driver entry-point query, so the link line needs no ``-lcuda``.

Nothing here runs at import: the CPU tests import every module, on
machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
LIB_NAME = "libkernels.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# C entry points: name -> argtypes (every function returns cudaError_t)
SIGNATURES = {
    # (P, h, u, e_cmp, e_scale | null, scalars, levels, L, newton_iters, n,
    #  gamma_out, b_out, e_out, phi_out, bits_out | null, stream)
    "dual_solve_levels_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _P, _P, _P, _P, _P, _P),
    # (P, h, u, e_cmp, e_scale | null, alive, q, mu, scalars, levels, L,
    #  newton_iters, cap, n, gamma_out, b_out, e_out, phi_out, bits_out | null,
    #  mu_out, lam_out, res_out, n_out, stream)
    "dual_ascent_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    # (x, out, ks, n_rows, d, block, flags, ws | null, ws_words, stream)
    "topk_rows_f32": (_P, _P, _P, _I, _LL, _I, _I, _P, _LL, _P),
    # (x, out, n, block, k, dtype, ws | null, ws_words, stream)
    "topk_block": (_P, _P, _LL, _I, _I, _I, _P, _LL, _P),
    # (block, out int[4]) / (dtype, block, out int[4]): registers, local
    # bytes, static and dynamic shared bytes of the top-k kernel for that
    # block width
    "topk_rows_attrs": (_I, _P),
    "topk_block_attrs": (_I, _I, _P),
    # (q, k, v, o, lse | null, B, Sq, Skv, H, KV, D, causal, window, scale,
    # stream): the fp32 kernels and the bf16 and fp16 tensor-core kernel
    "flash_attention_fwd_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _I, _I, _F, _P),
    "flash_attention_fwd_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _F, _P),
    "flash_attention_fwd_f16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _I, _I, _F, _P),
    # (D, out int[6]: registers, local bytes, static and dynamic shared bytes,
    # the cluster size, the clusters the card holds)
    "flash_attention_attrs_f32": (_I, _P),
    "flash_attention_attrs_bf16": (_I, _P),
    "flash_attention_attrs_f16": (_I, _P),
    # (dtype 0 bf16 / 1 fp16 / 2 fp32, q, k, v, o, lse | null, ws, maxes, B,
    # Sq, Skv, H, KV, D, causal, window, scale, bh0, nbh, t0, nt, ld, stream):
    # one piece of the split route
    "flash_attention_split": (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _P),
    # (dtype, D, out int[8]): the scores kernel's registers, local bytes,
    # static and dynamic shared bytes, then the P V kernel's
    "flash_attention_split_attrs": (_I, _I, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/ on first use and need the CUDA toolkit")


def _stamp(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile ``csrc/*.cu`` into ``BUILD_DIR/libkernels.so`` unless a
    library built from the same sources and flags is already there."""
    sources = sorted(CSRC.glob("*.cu"))
    stamp = _stamp(sources + sorted(CSRC.glob("*.cuh")))
    lib = BUILD_DIR / LIB_NAME
    stamp_file = BUILD_DIR / (LIB_NAME + ".sha256")
    if (lib.exists() and stamp_file.exists()
            and stamp_file.read_text() == stamp):
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [BUILD_DIR / (s.stem + f".{os.getpid()}.o") for s in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for s, o in zip(sources, objs)]
    logs = [p.communicate()[0].decode() for p in procs]
    failed = [(s.name, log) for s, p, log in zip(sources, procs, logs)
              if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {name}\n{log}" for name, log in failed))
    tmp = BUILD_DIR / (LIB_NAME + f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)
    stamp_file.write_text(stamp)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")
