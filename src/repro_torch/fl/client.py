"""FL client: all clients' local training at once, as one batched step.

With ``local_steps=1`` the update equals the (negative-scaled) gradient —
the paper's setting; larger values give standard FedAvg deltas.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad_and_value, vmap

from ..kernels.score_norm.ops import row_l2_norms
from ..optim import make_optimizer
from .updates import flatten_update

# Clients a call of the vmapped step. Every call holds exactly this many
# (the last one padded with copies of a real client's batches, whose rows
# are dropped), so every convolution and GEMM of the step has one shape
# whatever the caller's client count: the library picks one algorithm, and
# a client's update does not depend on how many clients share the step or
# where it sits in it (ROADMAP C-17: the sharded trainer's rank holds fewer
# clients than one card). The value is measured on the H100 (PERF.md).
CLIENT_CHUNK = 50


def make_batched_client_step(loss_fn: Callable, lr: float,
                             opt_name: str = "sgd", **opt_kw):
    """Returns ``fn(params, batches) -> (updates [N, D], u_norms [N],
    losses [N])``.

    ``loss_fn(params, batch) -> (loss, aux)`` is a function of a params
    dict; ``batches`` maps fields to tensors with leading dims
    ``[n_clients, local_steps, ...]``. Every client starts from the same
    global params: ``torch.func.vmap`` runs ``CLIENT_CHUNK`` clients at a
    time over ``torch.func.grad_and_value``, with the (small, static) local
    steps unrolled and the optimizer state initialized once and threaded
    through them. Updates come back flattened (fp32, the JAX package's leaf order);
    ``u_norms`` are their row norms from the score-norm kernel (its plain
    version on the CPU); ``losses`` are each client's last-step loss.
    """
    opt_init, opt_update = make_optimizer(opt_name, **opt_kw)
    value_and_grad = grad_and_value(loss_fn, has_aux=True)

    def one_client(params, client_batches):
        n_steps = next(iter(client_batches.values())).shape[0]
        p, state = params, opt_init(params)
        loss = None
        for s in range(n_steps):
            batch = {k: v[s] for k, v in client_batches.items()}
            grads, (loss, _) = value_and_grad(p, batch)
            p, state = opt_update(grads, state, p, lr)
        delta = {k: p[k] - params[k] for k in params}
        return flatten_update(delta), loss

    batched = vmap(one_client, in_dims=(None, 0))

    def step(params, batches):
        n = next(iter(batches.values())).shape[0]
        c = CLIENT_CHUNK
        n_pad = -(-n // c) * c
        if n_pad > n:
            batches = {k: torch.cat([v, v[-1:].expand(n_pad - n, *v.shape[1:])])
                       for k, v in batches.items()}
        updates = losses = None
        cudnn = torch.backends.cudnn
        saved = cudnn.deterministic, cudnn.benchmark
        # cuDNN's fastest algorithms for some of these shapes add with
        # atomics, so two calls would differ in the last bits
        cudnn.deterministic, cudnn.benchmark = True, False
        try:
            for i in range(0, n_pad, c):
                u, lo = batched(params, {k: v[i:i + c] for k, v in batches.items()})
                if updates is None:
                    updates = u.new_empty((n, u.shape[1]))
                    losses = lo.new_empty((n,))
                m = min(c, n - i)
                updates[i:i + m] = u[:m]
                losses[i:i + m] = lo[:m]
        finally:
            cudnn.deterministic, cudnn.benchmark = saved
        return updates, row_l2_norms(updates), losses

    return step
