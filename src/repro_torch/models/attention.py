"""GQA attention: RoPE, optional QKV bias, causal / sliding-window masks,
and cross-attention.

A port of ``repro.models.attention``, in the JAX layout (``wq``, ``wk``,
``wv``, ``wo``, each ``[in, out]``). Three execution paths:

* ``attention_forward`` — train/prefill. Short sequences take the direct
  softmax(QK^T)V in plain PyTorch (probabilities rounded to v's type
  before PV, as the JAX package does); long ones take the flash branch,
  which is ``kernels.flash_attention`` (the CUDA kernel for CUDA tensors,
  its plain version on the CPU) where the JAX package runs its chunked
  online-softmax jnp scan. Under grad the wrapper goes through its
  autograd Function (the kernel's forward with its log-sum-exp, the JAX
  package's blockwise recompute backward), so the gradient reaches q, k
  and v. The branch rule is the JAX package's: the flash branch when
  ``max(Sq, Skv) >= _FLASH_THRESHOLD`` and both lengths split into
  chunks (``_chunk_of``) of more than one row.
* ``attention_decode`` — one new token against a ring KV cache of
  ``cache_len`` slots with per-slot absolute positions (``slot_pos``),
  plain PyTorch. The cache tensors are updated in place (the JAX package
  returns new arrays; nothing reads the old ones).
* cross-attention (whisper) — ``kv_x`` gives the keys and values of
  ``attention_forward`` (positions ``arange(Skv)``, no RoPE on whisper's
  calls; non-causal, ``Skv`` != ``Sq``, through either branch);
  ``make_cross_cache`` projects the encoder's states once for decode and
  ``cross_attention_decode`` attends one token to them, plain PyTorch.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..kernels.flash_attention import flash_attention
from ..sharding import act
from .layers import apply_rope
from .module import Dense, _device_of

_FLASH_THRESHOLD = 2048  # use the flash branch for seqs at/above this
_Q_CHUNK = 1024
_KV_CHUNK = 1024
NEG_INF = -1e30


def _chunk_of(S: int, target: int) -> int:
    """Largest divisor of S that is <= target (the JAX package's chunk
    size; the branch rule depends on it)."""
    c = min(target, S)
    while c > 1 and S % c:
        c -= 1
    return c


class Attention(nn.Module):
    def __init__(self, cfg, generator: torch.Generator | None = None):
        super().__init__()
        dev = _device_of(generator)
        hd = cfg.resolved_head_dim
        d = cfg.d_model
        self.wq = Dense(d, cfg.n_heads * hd, bias=cfg.qkv_bias, device=dev)
        self.wk = Dense(d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, device=dev)
        self.wv = Dense(d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, device=dev)
        self.wo = Dense(cfg.n_heads * hd, d, bias=False, device=dev)
        for m in (self.wq, self.wk, self.wv, self.wo):
            m.reset_parameters(generator)


def _split_heads(x: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    return act.split_last(x, n_heads, head_dim)


def _mask(q_positions, kv_positions, causal, window) -> torch.Tensor:
    mask = torch.ones(q_positions.shape[0], kv_positions.shape[0],
                      dtype=torch.bool, device=q_positions.device)
    if causal:
        mask &= kv_positions[None, :] <= q_positions[:, None]
    if window is not None:
        mask &= q_positions[:, None] - kv_positions[None, :] < window
    return mask


def _direct_attention(q, k, v, *, scale, causal, window, q_positions, kv_positions):
    """q: [B,Sq,KV,G,D]; k/v: [B,Skv,KV,D] -> [B,Sq,KV,G,D]."""
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    mask = _mask(q_positions, kv_positions, causal, window)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)


def uses_flash(Sq: int, Skv: int) -> bool:
    """The JAX package's branch rule: the flash branch for long sequences
    whose lengths both split into chunks of more than one row."""
    return (max(Sq, Skv) >= _FLASH_THRESHOLD and _chunk_of(Sq, _Q_CHUNK) > 1
            and _chunk_of(Skv, _KV_CHUNK) > 1)


def attention_forward(params: Attention, x: torch.Tensor, cfg, *,
                      causal: bool = True,
                      window: Optional[int] = None,
                      positions: Optional[torch.Tensor] = None,
                      kv_x: Optional[torch.Tensor] = None,
                      use_rope: bool = True,
                      return_kv: bool = False):
    """x: [B, Sq, d]; kv_x (cross-attention source): [B, Skv, d]. With
    return_kv=True also returns the post-RoPE (k, v) ``[B, Skv, KV, hd]``
    for prefill cache construction."""
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    G = H // KV
    B, Sq = x.shape[0], x.shape[1]
    src = kv_x if kv_x is not None else x
    Skv = src.shape[1]

    q = _split_heads(params.wq(x), H, hd)
    k = _split_heads(params.wk(src), KV, hd)
    v = _split_heads(params.wv(src), KV, hd)

    q_positions = (positions if positions is not None
                   else torch.arange(Sq, device=x.device))
    kv_positions = (torch.arange(Skv, device=x.device)
                    if kv_x is not None or positions is None else positions)
    if use_rope:
        q = apply_rope(q, q_positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)

    if uses_flash(Sq, Skv):
        # positions are arange here, as on the JAX package's flash branch
        out = flash_attention(q, k, v, causal=causal, window=window)
    else:
        out = _direct_attention(act.split_dim(q, 2, KV, G), k, v,
                                scale=1.0 / float(hd) ** 0.5, causal=causal,
                                window=window, q_positions=q_positions,
                                kv_positions=kv_positions)
    out = act.reshape(out, (B, Sq, H * hd)).to(x.dtype)
    y = params.wo(out)
    if return_kv:
        return y, (k, v)
    return y


# ------------------------------------------------------------- KV cache ----
def fill_kv_cache(k: torch.Tensor, v: torch.Tensor, cache_len: int,
                  dtype: torch.dtype) -> dict:
    """Build a decode-ready ring cache from prefill K/V ([B,S,KV,hd]).
    Keeps the last ``cache_len`` positions, placed at slot = pos % cache_len
    so decode's ring indexing continues seamlessly."""
    S = k.shape[1]
    keep = min(S, cache_len)
    pos = torch.arange(S - keep, S, device=k.device)
    slots = torch.remainder(pos, cache_len)

    def ring(t):
        # position p at slot p % cache_len: the kept tail rotated by the
        # first kept slot, or the prompt then empty slots (built, not
        # written in place, so a DTensor k stays one)
        t = t[:, S - keep:].to(dtype)
        if keep == cache_len:
            return torch.roll(t, S % cache_len, dims=1)
        pad = torch.zeros((t.shape[0], cache_len - keep) + tuple(t.shape[2:]),
                          dtype=dtype, device=t.device)
        return torch.cat([t, pad], dim=1)
    kk, vv = ring(k), ring(v)
    slot_pos = torch.full((cache_len,), -1, dtype=torch.int32, device=k.device)
    slot_pos[slots] = pos.to(torch.int32)
    return {"k": kk, "v": vv, "slot_pos": slot_pos}


def make_kv_cache(cfg, batch: int, cache_len: int, dtype: torch.dtype,
                  device=None) -> dict:
    hd = cfg.resolved_head_dim
    shape = (batch, cache_len, cfg.n_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "slot_pos": torch.full((cache_len,), -1, dtype=torch.int32, device=device),
    }


def attention_decode(params: Attention, x: torch.Tensor, cache: dict, pos: int,
                     cfg, *, window: Optional[int] = None,
                     use_rope: bool = True) -> tuple[torch.Tensor, dict]:
    """One-token decode. x: [B, 1, d]; pos: the absolute position (int, the
    same for the whole batch). Writes the token's K/V into slot
    ``pos % cache_len`` of ``cache`` in place and returns (y, cache)."""
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    G = H // KV
    B = x.shape[0]
    W = cache["k"].shape[1]
    pos = int(pos)

    q = _split_heads(params.wq(x), H, hd)                     # [B,1,H,D]
    k = _split_heads(params.wk(x), KV, hd)                    # [B,1,KV,D]
    v = _split_heads(params.wv(x), KV, hd)
    pos_arr = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    if use_rope:
        q = apply_rope(q, pos_arr, cfg.rope_theta)
        k = apply_rope(k, pos_arr, cfg.rope_theta)            # absolute pos at write

    slot = pos % W
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    cache["slot_pos"][slot] = pos
    new_k, new_v, slot_pos = cache["k"], cache["v"], cache["slot_pos"]

    qg = act.split_dim(q, 2, KV, G)
    root = torch.full((), math.sqrt(hd), dtype=torch.float32, device=x.device)
    scores = torch.einsum("bqkgd,bskd->bkgs", qg.float(), new_k.float()) / root
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window is not None:
        valid &= pos - slot_pos < window
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs.to(new_v.dtype), new_v)
    out = act.reshape(out, (B, 1, H * hd)).to(x.dtype)
    return params.wo(out), cache


# ------------------------------------------------- cross-attention cache ----
def make_cross_cache(params: Attention, enc_out: torch.Tensor, cfg) -> dict:
    """The encoder's keys and values ``[B, F, KV, hd]`` in the activation's
    type, projected once for decode (whisper's cross-attention)."""
    hd = cfg.resolved_head_dim
    return {"k": _split_heads(params.wk(enc_out), cfg.n_kv_heads, hd),
            "v": _split_heads(params.wv(enc_out), cfg.n_kv_heads, hd)}


def cross_attention_decode(params: Attention, x: torch.Tensor, cross: dict,
                           cfg) -> torch.Tensor:
    """One token x ``[B, 1, d]`` against every encoder position of
    ``cross`` (no mask)."""
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    B = x.shape[0]
    q = act.split_dim(_split_heads(params.wq(x), H, hd), 2, KV, H // KV)
    root = torch.full((), math.sqrt(hd), dtype=torch.float32, device=x.device)
    scores = torch.einsum("bqkgd,bskd->bkgs", q.float(), cross["k"].float()) / root
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs.to(cross["v"].dtype), cross["v"])
    return params.wo(act.reshape(out, (B, 1, H * hd)).to(x.dtype))
