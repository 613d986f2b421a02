"""Mixture-of-Experts FFN with capacity-based one-hot dispatch.

A port of ``repro.models.moe`` (qwen2-moe, mixtral). Per group of
``g = min(cfg.moe_group, S)`` tokens of a batch row, each token's top-k
experts get a capacity slot from a masked cumulative sum; a token over an
expert's capacity ``max(1, int(capacity_factor * k * g / E))`` is dropped
(the residual passes it through). So a decode step (g = 1) has capacity 1
and drops nothing. The dispatch and combine tensors, and so the masks and
slots, are the JAX package's bit for bit: 0/1 values, ``torch.argmax``'s
first index on ties as ``jnp.argmax``'s, integer cumulative sums.

The router runs in fp32 (x and its weight cast per call, as the JAX
package does), so a serving copy (``transformer.for_compute``) keeps its
weight fp32; the expert stacks ``w_gate``/``w_up`` ``[E, d, f]`` and
``w_down`` ``[E, f, d]`` are raw parameters cast to the activation's type
per call. The expert products are plain einsums, as in the JAX package
(no Pallas kernel there).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..sharding import act
from .layers import SwiGLU, swiglu
from .module import Dense, _device_of, trunc_normal_fan_in


class MoE(nn.Module):
    def __init__(self, cfg, generator: torch.Generator | None = None):
        super().__init__()
        dev = _device_of(generator)
        d, E = cfg.d_model, cfg.n_experts
        d_ff = cfg.moe_d_ff or cfg.d_ff
        self.router = Dense(d, E, bias=False, device=dev)
        self.router.reset_parameters(generator)
        # E fan-in [d_in, d_out] weights, as dense_init vmapped over experts
        self.w_gate = trunc_normal_fan_in((E, d, d_ff), d, generator, dev)
        self.w_up = trunc_normal_fan_in((E, d, d_ff), d, generator, dev)
        self.w_down = trunc_normal_fan_in((E, d_ff, d), d_ff, generator, dev)
        if cfg.n_shared_experts:
            self.shared = SwiGLU(d, cfg.n_shared_experts * d_ff, generator)


def _dispatch_tensors(router_probs: torch.Tensor, k: int, capacity: int):
    """router_probs: [G, g, E] (token groups) -> dispatch, combine
    [G, g, E, C] in the probs' type."""
    G, S, E = router_probs.shape
    dt, dev = router_probs.dtype, router_probs.device
    probs = router_probs
    dispatch = torch.zeros((G, S, E, capacity), dtype=dt, device=dev)
    combine = torch.zeros_like(dispatch)
    slots = torch.arange(capacity, device=dev)
    fill = torch.zeros((G, E), dtype=torch.int32, device=dev)  # accepted so far
    for _ in range(k):
        top = torch.argmax(probs, dim=-1)                        # [G, g]
        top_p = torch.gather(probs, -1, top[..., None])[..., 0]
        onehot = F.one_hot(top, E).to(torch.int32)               # [G, g, E]
        # position of each token in its chosen expert's queue
        pos_in_expert = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot \
            + fill[:, None, :]
        pos = torch.sum(onehot * pos_in_expert, dim=-1)          # [G, g]
        keep = pos < capacity
        slot = (pos[..., None] == slots).to(dt)                  # one_hot; 0 past C
        d = onehot.to(dt)[..., None] * slot[:, :, None, :]
        d = d * keep[..., None, None].to(dt)
        dispatch = dispatch + d
        combine = combine + d * top_p[..., None, None]
        fill = fill + torch.sum(onehot * keep[..., None].to(torch.int32), dim=1,
                                dtype=torch.int32)
        probs = probs * (1.0 - onehot.to(dt))                    # mask the chosen
    return dispatch, combine


def router_probs(params: MoE, x: torch.Tensor) -> torch.Tensor:
    """Softmax of the fp32 router logits: [B, S, d] -> [B, S, E] fp32."""
    logits = act.matmul(x.float(), params.router.w.float())
    return torch.softmax(logits, dim=-1)


def moe_forward(params: MoE, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y, aux loss). Capacity is per (batch row x group)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.n_experts_per_tok
    g = min(cfg.moe_group, S)
    if S % g:
        raise ValueError(f"sequence {S} is not a multiple of the MoE group {g}")
    ng = S // g
    capacity = max(1, int(cfg.capacity_factor * k * g / E))

    probs = router_probs(params, x)
    dispatch, combine = _dispatch_tensors(act.reshape(probs, (B * ng, g, E)), k, capacity)
    dispatch = dispatch.to(x.dtype)                              # [Bg, g, E, C]
    combine = combine.to(x.dtype)

    xg = act.reshape(x, (B * ng, g, d))
    # the token groups sharded as the batch, the experts whole (a layout
    # for the sharding plan: no-op outside activation_rules)
    xin = act.constrain(torch.einsum("tsec,tsd->tecd", dispatch, xg),  # [Bg, E, C, d]
                        "batch", None, None, None)
    h = F.silu(torch.einsum("tecd,edf->tecf", xin, params.w_gate.to(x.dtype))) \
        * torch.einsum("tecd,edf->tecf", xin, params.w_up.to(x.dtype))
    h = act.constrain(h, "batch", None, None, "ff")
    out = torch.einsum("tecf,efd->tecd", h, params.w_down.to(x.dtype))
    y = act.reshape(torch.einsum("tsec,tecd->tsd", combine, out), (B, S, d))

    if hasattr(params, "shared"):
        y = y + swiglu(params.shared, x)

    # Switch-style load-balance loss: mean router prob x fraction routed
    me = torch.mean(probs, dim=(0, 1))
    ce = torch.mean(dispatch.sum(-1).float(), dim=(0, 1))
    aux = E * torch.sum(me * ce) * cfg.router_aux_coef
    return y, aux
