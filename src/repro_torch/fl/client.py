"""FL client: local training, one client at a time (``make_local_step``,
``local_update``) or all clients at once as one batched step.

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


def _to_tensors(batch: dict, device) -> dict:
    """A host batch (numpy arrays, as ``ClientDataset.next_batch`` gives)
    as tensors on ``device``: floating fields float32, integer ones int64
    (``stack_client_datasets``' types)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        t = t.to(torch.float32) if t.is_floating_point() else t.to(torch.int64)
        out[k] = t.to(device)
    return out


def make_local_step(loss_fn: Callable, lr: float, opt_name: str = "sgd",
                    **opt_kw):
    """Returns ``fn(params, batch, opt_state=None) -> (new_params,
    opt_state, metrics)``: one optimizer step of one client on ``loss_fn(
    params, batch) -> (loss, aux dict)``, its gradient by
    ``torch.func.grad_and_value``. Pass the returned ``opt_state`` back into
    the next call (momentum and AdamW moments accumulate); ``None``
    initializes a fresh one. ``metrics`` is the aux dict with ``loss``.
    ``batch`` may hold numpy arrays; the caller's params are not changed."""
    opt_init, opt_update = make_optimizer(opt_name, **opt_kw)
    value_and_grad = grad_and_value(loss_fn, has_aux=True)

    def step(params, batch, opt_state=None):
        dev = next(iter(params.values())).device
        batch = _to_tensors(batch, dev)
        if opt_state is None:
            opt_state = opt_init(params)
        grads, (loss, metrics) = value_and_grad(params, batch)
        new_params, opt_state = opt_update(grads, opt_state, params, lr)
        return new_params, opt_state, dict(metrics, loss=loss)

    return step


def local_update(params: dict, dataset, local_step, n_steps: int):
    """``n_steps`` minibatch steps of ``local_step`` on
    ``dataset.next_batch()``, the optimizer state threaded through the
    loop; returns (the delta dict, the last step's metrics)."""
    p, state, metrics = params, None, None
    for _ in range(n_steps):
        p, state, metrics = local_step(p, dataset.next_batch(), state)
    return {k: p[k] - params[k] for k in params}, metrics


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
