"""SGD with optional momentum (paper uses plain SGD, lr=0.01), on dicts of
tensors (functional, so it composes with ``torch.func`` transforms)."""
from __future__ import annotations


def sgd_init(params: dict, *, momentum: float = 0.0) -> dict:
    if momentum == 0.0:
        return {}
    return {"m": {k: v.new_zeros(v.shape) for k, v in params.items()}}


def sgd_update(grads: dict, state: dict, params: dict, lr, *,
               momentum: float = 0.0):
    if momentum == 0.0:
        return {k: p - lr * grads[k].to(p.dtype) for k, p in params.items()}, state
    m = {k: momentum * state["m"][k] + grads[k].to(state["m"][k].dtype)
         for k in params}
    return {k: p - lr * m[k] for k, p in params.items()}, {"m": m}
