"""Functional optimizers on dicts of tensors."""
from .adamw import adamw_init, adamw_update
from .sgd import sgd_init, sgd_update

__all__ = ["adamw_init", "adamw_update", "sgd_init", "sgd_update",
           "make_optimizer"]


def make_optimizer(name: str, **kw):
    """Returns (init_fn(params) -> state, update_fn(grads, state, params, lr)
    -> (new_params, new_state))."""
    if name == "sgd":
        momentum = kw.get("momentum", 0.0)
        return (lambda p: sgd_init(p, momentum=momentum),
                lambda g, s, p, lr: sgd_update(g, s, p, lr, momentum=momentum))
    if name == "adamw":
        weight_decay = kw.get("weight_decay", 0.0)

        def update(g, s, p, lr):
            # adamw_update works in place; this entry, like the JAX
            # package's, leaves the caller's params and state as they were
            p = {k: v.detach().clone() for k, v in p.items()}
            s = {"m": {k: v.clone() for k, v in s["m"].items()},
                 "v": {k: v.clone() for k, v in s["v"].items()},
                 "step": s["step"].clone()}
            return adamw_update(g, s, p, lr, weight_decay=weight_decay)
        return adamw_init, update
    raise ValueError(name)
