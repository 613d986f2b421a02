"""Where the port runs: the GPU unless the caller asks for the CPU."""
from __future__ import annotations

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
