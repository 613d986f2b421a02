"""Mamba2 (SSD) block: the chunked scan of the JAX package.

A port of ``repro.models.ssm``. Per head h (state size N, head dim P):

    a_t = exp(dt_t A_h)                       (a scalar decay a step)
    S_t = a_t S_{t-1} + dt_t B_t (x) x_t      (S in R^{N x P}, fp32)
    y_t = C_t^T S_t + D_h x_t

``mamba2_forward`` splits the sequence into chunks of ``cfg.ssm_chunk``:
within a chunk the recurrence is a decay-masked [Q, Q] product (the mask
inside the ``exp``, as the JAX package puts it), and the state is carried
across chunks by a Python loop where the JAX package scans. Plain einsums,
as in the JAX package (no Pallas kernel there). ``mamba2_decode`` is the
step-wise recurrence; its cache holds the pre-conv ``xBC`` tail and the
state.

``conv_w [K, C]``, ``conv_b``, ``A_log``, ``dt_bias`` and ``D`` are raw
fp32 parameters: the prefill's causal conv casts ``conv_w`` to the
activation's type per call, and decode convolves in fp32 against it, so a
serving copy keeps it fp32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..sharding import act
from .layers import RMSNorm, rmsnorm
from .module import Dense, _device_of


class Mamba2(nn.Module):
    """Fused ``in_proj`` to [z, xBC, dt], the depthwise conv, the SSD
    parameters, a gated RMSNorm and ``out_proj``."""

    def __init__(self, cfg, generator: torch.Generator | None = None):
        super().__init__()
        dev = _device_of(generator)
        d_inner = cfg.ssm_expand * cfg.d_model
        n_heads = d_inner // cfg.ssm_head_dim
        N = cfg.ssm_state
        conv_dim = d_inner + 2 * N
        self.in_proj = Dense(cfg.d_model, 2 * d_inner + 2 * N + n_heads, bias=False,
                             device=dev)
        self.in_proj.reset_parameters(generator)
        conv_w = torch.empty(cfg.ssm_conv, conv_dim, device=dev)
        dt = torch.empty(n_heads, device=dev)
        with torch.no_grad():
            conv_w.normal_(0.0, 1.0, generator=generator).mul_(0.1)
            dt.uniform_(math.log(1e-3), math.log(1e-1), generator=generator)
        self.conv_w = nn.Parameter(conv_w)
        self.conv_b = nn.Parameter(torch.zeros(conv_dim, device=dev))
        self.A_log = nn.Parameter(torch.log(torch.linspace(1.0, 16.0, n_heads,
                                                           device=dev)))
        self.dt_bias = nn.Parameter(torch.log(torch.expm1(torch.exp(dt))))
        self.D = nn.Parameter(torch.ones(n_heads, device=dev))
        self.norm = RMSNorm(d_inner, device=dev)
        self.out_proj = Dense(d_inner, cfg.d_model, bias=False, device=dev)
        self.out_proj.reset_parameters(generator)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of width K in the activation's type: K shifted
    slices added in Python ``sum`` order. xBC: [B, S, C]; w: [K, C]."""
    K, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + S] * w[i].to(xBC.dtype) for i in range(K))
    return F.silu(out + b.to(xBC.dtype))


def _split_proj(params: Mamba2, x, cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    N = cfg.ssm_state
    zxbcdt = params.in_proj(x)
    z, xBC, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * N,
                                      zxbcdt.shape[-1] - 2 * d_inner - 2 * N], dim=-1)
    return z, xBC, dt, d_inner, N, d_inner // cfg.ssm_head_dim


def mamba2_forward(params: Mamba2, x: torch.Tensor, cfg, *, return_state: bool = False):
    """x: [B, S, d_model] -> [B, S, d_model], S a multiple of the chunk.
    With ``return_state`` also the decode cache ``{"conv": the last K - 1
    pre-conv xBC rows, "state": [B, H, N, P] fp32}``."""
    B, S, _ = x.shape
    P = cfg.ssm_head_dim
    z, xBC, dt, d_inner, N, H = _split_proj(params, x, cfg)
    xBC_raw = xBC
    xBC = _causal_conv(xBC, params.conv_w, params.conv_b)
    xs, Bmat, Cmat = torch.split(xBC, [d_inner, N, N], dim=-1)
    xh = act.split_last(xs, H, P)

    # JAX's softplus is logaddexp(x, 0); torch's returns x above 20, where
    # log1p(exp(-x)) < 2.1e-9 is below half an fp32 ulp of x: equal in fp32
    dt = F.softplus(dt.float() + params.dt_bias)                 # [B, S, H]
    A = -torch.exp(params.A_log)                                 # [H]
    log_a = dt * A                                               # < 0

    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {Q}")
    xf, Bf, Cf = xh.float(), Bmat.float(), Cmat.float()
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))[None, :, :, None]
    state = torch.zeros(B, H, N, P, device=x.device)
    # [B, S / Q, Q, ...] views: chunk c is the slice [c Q, (c + 1) Q) of the
    # sequence, and under the sharding plan one redistribution a tensor
    # a layer, not one a chunk (act.chunked)
    chunks = [act.chunked(t, Q) for t in (xf, Bf, Cf, dt, log_a)]
    ys = []
    for c in range(S // Q):
        xq, Bq, Cq, dtq, laq = (t[:, c] for t in chunks)
        L = torch.cumsum(laq, dim=1)                             # [B, Q, H]
        # intra-chunk: M[t, s] = (C_t . B_s) exp(L_t - L_s) dt_s, s <= t
        CB = torch.einsum("bqn,bsn->bqs", Cq, Bq)
        diff = L[:, :, None, :] - L[:, None, :, :]               # [B, t, s, H]
        # the mask inside the exp (exp(diff) of a masked pair may be inf)
        decay = torch.exp(torch.where(mask, diff, -1e9))
        Mts = CB[:, :, :, None] * decay * dtq[:, None, :, :]
        y_intra = torch.einsum("btsh,bshp->bthp", Mts, xq)
        # inter-chunk: exp(L_t) C_t^T S_prev
        y_inter = torch.einsum("bqn,bhnp->bqhp", Cq, state) * torch.exp(L)[..., None]
        rem = torch.exp(L[:, -1:, :] - L)                        # exp(L_Q - L_s)
        sc = torch.einsum("bsn,bshp->bhnp", Bq, xq * (rem * dtq)[..., None])
        state = torch.exp(L[:, -1, :])[:, :, None, None] * state + sc
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)
    y = y + params.D[None, None, :, None] * xf
    y = act.reshape(y, (B, S, d_inner)).to(x.dtype)
    y = rmsnorm(params.norm.scale, y * F.silu(z), cfg.norm_eps)
    out = params.out_proj(y)
    if return_state:
        K = cfg.ssm_conv
        tail = (xBC_raw[:, S - (K - 1):] if S >= K - 1
                else F.pad(xBC_raw, (0, 0, K - 1 - S, 0)))
        return out, {"conv": tail, "state": state}
    return out


def make_ssm_cache(cfg, batch: int, dtype: torch.dtype, device=None) -> dict:
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    N = cfg.ssm_state
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, d_inner + 2 * N),
                                dtype=dtype, device=device),
            "state": torch.zeros((batch, H, N, cfg.ssm_head_dim), device=device)}


def mamba2_decode(params: Mamba2, x: torch.Tensor, cache: dict, cfg
                  ) -> tuple[torch.Tensor, dict]:
    """One step. x: [B, 1, d_model]. Returns (y, a new cache dict)."""
    B = x.shape[0]
    P = cfg.ssm_head_dim
    z, xBC, dt, d_inner, N, H = _split_proj(params, x, cfg)
    window = torch.cat([cache["conv"], xBC], dim=1)              # [B, K, C]
    conv = torch.einsum("bkc,kc->bc", window.float(), params.conv_w) + params.conv_b
    xBC1 = F.silu(conv)[:, None, :].to(x.dtype)
    xs, Bmat, Cmat = torch.split(xBC1, [d_inner, N, N], dim=-1)
    xh = act.split_last(xs, H, P)[:, 0].float()
    Bv, Cv = Bmat[:, 0].float(), Cmat[:, 0].float()              # [B, N]
    dtv = F.softplus(dt[:, 0].float() + params.dt_bias)          # [B, H]
    a = torch.exp(dtv * (-torch.exp(params.A_log))[None, :])
    state = a[:, :, None, None] * cache["state"] + \
        torch.einsum("bn,bhp->bhnp", Bv, xh * dtv[..., None])
    y = torch.einsum("bn,bhnp->bhp", Cv, state) + params.D[None, :, None] * xh
    y = act.reshape(y, (B, 1, d_inner)).to(x.dtype)
    y = rmsnorm(params.norm.scale, y * F.silu(z), cfg.norm_eps)
    return params.out_proj(y), {"conv": window[:, 1:], "state": state}
