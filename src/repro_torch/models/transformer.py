"""Decoder-only LM of the dense family (GQA attention + SwiGLU).

A port of ``repro.models.transformer`` for ``family="dense"`` (tinyllama,
qwen2.5-32b, glm4-9b, qwen2-72b). The LM is an ``nn.Module`` whose
``layers`` is a list of blocks where the JAX package stacks them for
``lax.scan``; ``repro_torch.convert.lm_params_from_numpy`` unstacks the
JAX package's leaves onto it. The moe, ssm, hybrid, audio and vlm families
raise ``NotImplementedError`` (ROADMAP A-19).

Parameters are fp32 masters; activations run in ``cfg.dtype``, each dense
weight and the embedding table cast per call, as the JAX package's
``dense``/``embed`` do, so training's gradients land on the fp32
parameters. ``for_compute(model, cfg)`` returns a serving copy whose dense
weights and embedding table are already in that type (the same bits as the
per-call cast), with the norm scales and the head kept fp32. With
``cfg.remat`` each block of a forward under grad runs under
``torch.utils.checkpoint`` (non-reentrant), as the JAX package's
``jax.checkpoint`` of the scanned block: the backward recomputes it, flash
attention included. Caches are ``{"layers": [per-layer ring KV cache]}``.
"""
from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import attention as attn
from .layers import RMSNorm, SwiGLU, rmsnorm, swiglu
from .module import Dense, Embed, _device_of, dtype_of, unembed

PORTED_FAMILIES = ("dense",)


def check_family(cfg) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: the port "
            "runs the dense LM family only (ROADMAP A-19)")


class DenseBlock(nn.Module):
    def __init__(self, cfg, generator: torch.Generator | None = None):
        super().__init__()
        dev = _device_of(generator)
        self.ln1 = RMSNorm(cfg.d_model, device=dev)
        self.attn = attn.Attention(cfg, generator)
        self.ln2 = RMSNorm(cfg.d_model, device=dev)
        self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, generator)


class LM(nn.Module):
    """Weights drawn from ``generator`` with the JAX init's distributions,
    on the generator's device."""

    def __init__(self, cfg, generator: torch.Generator | None = None):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        dev = _device_of(generator)
        self.embed = Embed(cfg.vocab_size, cfg.d_model, generator)
        self.ln_f = RMSNorm(cfg.d_model, device=dev)
        self.layers = nn.ModuleList(DenseBlock(cfg, generator)
                                    for _ in range(cfg.n_layers))
        if not cfg.tie_embeddings:
            self.lm_head = Embed(cfg.vocab_size, cfg.d_model, generator)

    def head(self) -> torch.Tensor:
        return self.embed.table if self.cfg.tie_embeddings else self.lm_head.table


def for_compute(model: LM, cfg) -> LM:
    """A copy of ``model`` with every dense weight and bias and the
    embedding table cast to ``cfg.dtype`` once; norm scales and ``lm_head``
    stay fp32. ``model`` itself when the compute type is fp32 or its dense
    weights are already in it."""
    dt = dtype_of(cfg)
    if all(m.w.dtype == dt for m in model.modules() if isinstance(m, Dense)):
        return model
    out = copy.deepcopy(model)
    with torch.no_grad():
        for m in out.modules():
            if isinstance(m, Dense):
                m.w.data = m.w.data.to(dt)
                if m.b is not None:
                    m.b.data = m.b.data.to(dt)
        if not cfg.tie_embeddings:     # a tied table is also the fp32 head
            out.embed.table.data = out.embed.table.data.to(dt)
    return out


def _dense_block(layer: DenseBlock, x, cfg, window):
    x = x + attn.attention_forward(layer.attn, rmsnorm(layer.ln1.scale, x, cfg.norm_eps),
                                   cfg, window=window)
    return x + swiglu(layer.mlp, rmsnorm(layer.ln2.scale, x, cfg.norm_eps))


def lm_forward(model: LM, tokens: torch.Tensor, cfg, *,
               window: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens: [B, S] int. Returns (logits [B,S,V] fp32, aux loss 0)."""
    check_family(cfg)
    x = model.embed(tokens, dtype_of(cfg))
    if window is None:
        window = cfg.sliding_window
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in model.layers:
        if remat:
            x = checkpoint(_dense_block, layer, x, cfg, window,
                           use_reentrant=False)
        else:
            x = _dense_block(layer, x, cfg, window)
    x = rmsnorm(model.ln_f.scale, x, cfg.norm_eps)
    return unembed(model.head(), x), torch.zeros((), device=x.device)


def lm_loss(model: LM, batch: dict, cfg) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy. batch: {"tokens": [B,S]} (+ optional
    "labels" [B,S], whose entries < 0 are masked out). Without labels the
    labels are ``tokens[:, 1:]`` against the logits of positions 0..S-2.
    Returns (loss + aux, {"xent": loss, "aux": aux})."""
    tokens = batch["tokens"]
    logits, aux = lm_forward(model, tokens, cfg)
    labels = batch.get("labels")
    if labels is None:
        labels = tokens[:, 1:]
        logits = logits[:, :-1]
    mask = (labels >= 0).to(torch.float32)
    lab = torch.clamp(labels, min=0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return loss + aux, {"xent": loss, "aux": aux}


def lm_prefill(model: LM, tokens: torch.Tensor, cfg, *, cache_len: int,
               window: Optional[int] = None) -> tuple[torch.Tensor, dict]:
    """Serving prefill: the forward pass that also builds each layer's ring
    KV cache. Returns (last-token logits [B,1,V], cache)."""
    check_family(cfg)
    dt = dtype_of(cfg)
    x = model.embed(tokens, dt)
    if window is None:
        window = cfg.sliding_window
    caches = []
    for layer in model.layers:
        y, (k, v) = attn.attention_forward(
            layer.attn, rmsnorm(layer.ln1.scale, x, cfg.norm_eps), cfg,
            window=window, return_kv=True)
        x = x + y
        x = x + swiglu(layer.mlp, rmsnorm(layer.ln2.scale, x, cfg.norm_eps))
        caches.append(attn.fill_kv_cache(k, v, cache_len, dt))
    x = rmsnorm(model.ln_f.scale, x[:, -1:], cfg.norm_eps)
    return unembed(model.head(), x), {"layers": caches}


def init_lm_cache(cfg, batch: int, cache_len: int, device=None) -> dict:
    """Empty per-layer ring caches."""
    check_family(cfg)
    dt = dtype_of(cfg)
    return {"layers": [attn.make_kv_cache(cfg, batch, cache_len, dt, device)
                       for _ in range(cfg.n_layers)]}


def lm_decode(model: LM, token: torch.Tensor, cache: dict, pos: int, cfg
              ) -> tuple[torch.Tensor, dict]:
    """One decode step. token: [B,1] int; pos: int. Returns (logits
    [B,1,V], cache), the cache updated in place."""
    check_family(cfg)
    x = model.embed(token, dtype_of(cfg))
    for layer, kv in zip(model.layers, cache["layers"]):
        y, _ = attn.attention_decode(layer.attn, rmsnorm(layer.ln1.scale, x, cfg.norm_eps),
                                     kv, pos, cfg)
        x = x + y
        x = x + swiglu(layer.mlp, rmsnorm(layer.ln2.scale, x, cfg.norm_eps))
    x = rmsnorm(model.ln_f.scale, x, cfg.norm_eps)
    return unembed(model.head(), x), cache
