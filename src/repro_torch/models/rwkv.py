"""RWKV6 ("Finch") time mix and channel mix: chunked linear attention with a
data-dependent per-channel decay [arXiv:2404.05892].

A port of ``repro.models.rwkv``. Per head (size M): receptance r_t, key
k_t, value v_t, decay w_t in (0,1)^M and bonus u; the fp32 state
S [M, M] follows

    y_t[j] = sum_i r_t[i] (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])
    S_t[i,j] = w_t[i] S_{t-1}[i,j] + k_t[i] v_t[j]

``rwkv6_forward`` evaluates it chunk by chunk (chunk 128, ``S % Q == 0``)
as the JAX package does: within a chunk the pairwise decays come from
log-space cumulative sums (``exp(-L)`` clamped at 30), the intra-chunk
mask is strictly lower-triangular, and the state is carried across chunks
by a Python loop where the JAX package scans. ``rwkv6_decode`` is the
step-wise recurrence. The JAX package runs these as plain einsums (no
Pallas kernel), and so does the port.

``mu``, ``w0``, the decay LoRA ``wA``/``wB`` and ``u`` are raw fp32
parameters (a serving copy keeps them fp32): ``xw @ wA`` runs in fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..sharding import act
from .layers import groupnorm
from .module import Dense, _device_of, trunc_normal_fan_in

_LORA_R = 32  # low-rank size of the data-dependent decay


def _dense(d_in: int, d_out: int, generator, device) -> Dense:
    m = Dense(d_in, d_out, bias=False, device=device)
    m.reset_parameters(generator)
    return m


class RWKV6(nn.Module):
    """The time mix: token-shift coefficients ``mu [5, d]`` for r, k, v,
    w, g; ``wr``/``wk``/``wv``/``wg``/``wo``; the decay
    ``w = exp(-exp(w0 + tanh(x wA) wB))``; the bonus ``u [H, M]``."""

    def __init__(self, cfg, generator: torch.Generator | None = None):
        super().__init__()
        dev = _device_of(generator)
        d, M = cfg.d_model, cfg.rwkv_head_size
        self.mu = nn.Parameter(torch.full((5, d), 0.5, device=dev))
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, _dense(d, d, generator, dev))
        self.w0 = nn.Parameter(torch.full((d,), -6.0, device=dev))
        self.wA = trunc_normal_fan_in((d, _LORA_R), d, generator, dev, scale=0.1)
        self.wB = trunc_normal_fan_in((_LORA_R, d), _LORA_R, generator, dev, scale=0.1)
        u = torch.empty(d // M, M, device=dev)
        with torch.no_grad():
            u.normal_(0.0, 1.0, generator=generator).mul_(0.1)
        self.u = nn.Parameter(u)


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None = None) -> torch.Tensor:
    """The x_{t-1} stream; ``prev`` [B, 1, d] is decode's carry (zeros at
    t = 0)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _mix(x, xx, mu):
    return x + (xx - x) * mu.to(x.dtype)


def _projections(params: RWKV6, x, xx):
    mu = params.mu
    r = params.wr(_mix(x, xx, mu[0]))
    k = params.wk(_mix(x, xx, mu[1]))
    v = params.wv(_mix(x, xx, mu[2]))
    xw = _mix(x, xx, mu[3]).float()
    g = params.wg(_mix(x, xx, mu[4]))
    log_w = -torch.exp(params.w0 + act.matmul(torch.tanh(act.matmul(xw, params.wA)),
                                              params.wB))                # < 0
    return r, k, v, g, log_w


def rwkv6_forward(params: RWKV6, x: torch.Tensor, cfg, *, chunk: int = 128,
                  return_state: bool = False):
    """x: [B, S, d] -> [B, S, d]; with ``return_state`` also the decode
    cache's ``{"state": [B, H, M, M] fp32, "shift": x[:, -1:]}``."""
    B, S, d = x.shape
    M = cfg.rwkv_head_size
    H = d // M
    r, k, v, g, log_w = _projections(params, x, _token_shift(x))
    r, k, v = (act.split_last(t.float(), H, M) for t in (r, k, v))
    log_w = act.split_last(log_w, H, M)
    u = params.u                                                 # [H, M]

    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {Q}")
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device),
                      diagonal=-1)[None, :, :, None]
    state = torch.zeros(B, H, M, M, device=x.device)
    # chunk c is the slice [c Q, (c + 1) Q) of the sequence; one
    # redistribution a tensor a layer under the sharding plan (act.chunked)
    chunks = [act.chunked(t, Q) for t in (r, k, v, log_w)]
    ys = []
    for c in range(S // Q):
        rq, kq, vq, lwq = (t[:, c] for t in chunks)
        # L_t: the cumulative log decay through step t (applied after use)
        L = torch.cumsum(lwq, dim=1)
        ratio_t = torch.exp(L - lwq)                             # <= 1
        # exp(-L) may overflow for a strong decay over a long chunk; past
        # -L_s > 30 every later ratio_t underflows to 0 anyway
        ratio_s = torch.exp(torch.clamp(-L, max=30.0))
        att = torch.einsum("bthm,bshm->btsh", rq * ratio_t, kq * ratio_s)
        att = torch.where(mask, att, 0.0)
        diag = torch.einsum("bthm,hm,bthm->bth", rq, u, kq)      # the bonus
        y = torch.einsum("btsh,bshm->bthm", att, vq) + diag[..., None] * vq
        y = y + torch.einsum("bthm,bhmn->bthn", rq * ratio_t, state)
        sc = torch.einsum("bshm,bshn->bhmn", kq * torch.exp(L[:, -1:] - L), vq)
        state = torch.exp(L[:, -1])[..., None] * state + sc
        ys.append(y)
    y = act.reshape(torch.cat(ys, dim=1), (B, S, d))
    y = groupnorm(y, H, cfg.norm_eps)
    y = y * F.silu(g.float())
    out = params.wo(y.to(x.dtype))
    if return_state:
        return out, {"state": state, "shift": x[:, -1:, :]}
    return out


def make_rwkv_cache(cfg, batch: int, dtype: torch.dtype, device=None) -> dict:
    d, M = cfg.d_model, cfg.rwkv_head_size
    return {"shift": torch.zeros((batch, 1, d), dtype=dtype, device=device),
            "state": torch.zeros((batch, d // M, M, M), device=device),
            "ffn_shift": torch.zeros((batch, 1, d), dtype=dtype, device=device)}


def rwkv6_decode(params: RWKV6, x: torch.Tensor, cache: dict, cfg
                 ) -> tuple[torch.Tensor, dict]:
    """One step. x: [B, 1, d]. Returns (y, a new cache dict)."""
    B, _, d = x.shape
    M = cfg.rwkv_head_size
    H = d // M
    r, k, v, g, log_w = _projections(params, x, cache["shift"])
    r, k, v = (act.split_last(t.float(), H, M)[:, 0] for t in (r, k, v))
    w = act.split_last(torch.exp(log_w), H, M)[:, 0]             # this step's decay
    s_prev = cache["state"]
    kv = torch.einsum("bhm,bhn->bhmn", k, v)
    y = torch.einsum("bhm,bhmn->bhn", r, s_prev + params.u[None, :, :, None] * kv)
    state = w[..., None] * s_prev + kv
    y = groupnorm(act.reshape(y, (B, 1, d)), H, cfg.norm_eps)
    y = y * F.silu(g.float())
    out = params.wo(y.to(x.dtype))
    return out, {"shift": x, "state": state, "ffn_shift": cache["ffn_shift"]}


# ------------------------------------------------- RWKV channel-mix FFN ----
class RWKVFFN(nn.Module):
    """``mu [2, d]`` (k, r), ``wk [d, d_ff]``, ``wv [d_ff, d]``, ``wr``."""

    def __init__(self, cfg, generator: torch.Generator | None = None):
        super().__init__()
        dev = _device_of(generator)
        self.mu = nn.Parameter(torch.full((2, cfg.d_model), 0.5, device=dev))
        self.wk = _dense(cfg.d_model, cfg.d_ff, generator, dev)
        self.wv = _dense(cfg.d_ff, cfg.d_model, generator, dev)
        self.wr = _dense(cfg.d_model, cfg.d_model, generator, dev)


def rwkv_ffn(params: RWKVFFN, x: torch.Tensor,
             prev: torch.Tensor | None = None) -> torch.Tensor:
    xx = _token_shift(x, prev)
    kx = _mix(x, xx, params.mu[0])
    rx = _mix(x, xx, params.mu[1])
    h = torch.square(torch.relu(params.wk(kx)))
    return torch.sigmoid(params.wr(rx)) * params.wv(h)
