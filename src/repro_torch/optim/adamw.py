"""AdamW on dicts of tensors — the port of ``repro.optim.adamw``: fp32
moments by default (``moment_dtype=torch.bfloat16`` halves their memory),
b1 0.9, b2 0.95, eps 1e-8, no weight decay.

The state is ``{"m": {name: tensor}, "v": {name: tensor}, "step": int32}``
over the parameters. ``adamw_update`` runs the JAX package's operations in
its order, each rounded to float32: ``t = float32(step)`` and the bias
corrections ``1 - b ** t`` with XLA's float32 ``pow`` (the C library's
``powf``; a Python double would differ in the last bits), the moments,
``(m / c1) / (sqrt(v / c2) + eps)``, then ``p - lr (upd + wd p)``. The
divisions by c1, c2 are true divisions by 0-d tensors on the parameters'
device (a CUDA tensor divided by a Python scalar is multiplied by its
reciprocal), so the card and the CPU round alike. It updates the
parameters and the moments in place, under ``no_grad`` (the JAX package
returns new trees; nothing reads the old ones), and returns them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..xla_math import pow_xla


def adamw_init(params: dict, *, moment_dtype=torch.float32) -> dict:
    def zeros(p):
        # laid out as the parameter: a DTensor parameter's moments are
        # DTensors of its placements
        return torch.zeros_like(p, dtype=moment_dtype,
                                memory_format=torch.contiguous_format)
    dev = next(iter(params.values())).device if params else None
    return {"m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _correction(b: float, t: np.float32) -> float:
    """float32 ``1 - b ** t`` as XLA computes it."""
    bt = pow_xla(b, torch.tensor([float(t)], dtype=torch.float32))
    return float(np.float32(1.0) - np.float32(bt[0]))


@torch.no_grad()
def adamw_update(grads: dict, state: dict, params: dict, lr, *, b1=0.9,
                 b2=0.95, eps=1e-8, weight_decay=0.0):
    """One AdamW step over ``params`` (name -> tensor) with ``grads`` of
    the same names. Returns ``(params, state)``, both updated in place."""
    step = state["step"] + 1
    t = np.float32(int(step))
    c1, c2 = _correction(b1, t), _correction(b2, t)
    consts = {}
    for k, p in params.items():
        dev = p.device
        if dev not in consts:
            consts[dev] = (torch.tensor(c1, device=dev), torch.tensor(c2, device=dev))
        c1_t, c2_t = consts[dev]
        m, v = state["m"][k], state["v"][k]
        g = grads[k].to(torch.float32)
        m2 = b1 * m.to(torch.float32) + (1 - b1) * g
        v2 = b2 * v.to(torch.float32) + (1 - b2) * g * g
        upd = torch.div(torch.div(m2, c1_t),
                        torch.sqrt(torch.div(v2, c2_t)) + eps)
        pf = p.to(torch.float32)
        p.copy_(pf - lr * (upd + weight_decay * pf))
        m.copy_(m2)
        v.copy_(v2)
    state["step"] = step
    return params, state
