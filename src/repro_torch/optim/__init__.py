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
    raise ValueError(name)
