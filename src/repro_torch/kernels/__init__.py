"""Hand-written Hopper kernels of the port, one package per TPU kernel.

Each package holds ``ref.py`` (the plain PyTorch version), the kernel
(CUDA C++ under ``repro_torch/csrc/``, or Triton in ``kernel.py``) and
``ops.py``, whose wrapper runs the plain version for CPU tensors and
launches the kernel for CUDA tensors, raising if it cannot. Each wrapper
counts its launches in a plain int attribute, ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch


def is_cpu(t: torch.Tensor) -> bool:
    """True for CPU tensors and for ``meta`` tensors (plain version: the
    dry-run's shapes, ``launch.dryrun``); False for CUDA tensors (kernel).
    Any other device raises."""
    if t.device.type in ("cpu", "meta"):
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}: the port runs on "
                         "CUDA, or on the CPU when asked")
    return False


def check_cuda(name: str, t: torch.Tensor, *, dtype: torch.dtype, ndim: int,
               device: torch.device) -> None:
    """Reject what a kernel does not take: wrong device, type, rank, or a
    non-contiguous layout."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
