"""Where the port runs: the GPU unless the caller asks for the CPU."""
from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. The port never falls back to the CPU
    silently — pass ``device="cpu"`` to run the plain PyTorch versions of
    the kernels."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible: the port runs on the GPU; pass "
                "device='cpu' to run it on the CPU")
        device = "cuda"
    return torch.device(device)


def rank_device(device=None, local_rank=None) -> torch.device:
    """The device of one rank of a process group: ``cuda:{local_rank}``
    (``local_rank`` defaults to the ``LOCAL_RANK`` that ``torchrun`` sets,
    else 0) unless the caller asks for the CPU or names a card. Raises
    without a GPU, as ``resolve_device`` does."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", int(local_rank))
