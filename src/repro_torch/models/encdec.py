"""Whisper-style encoder-decoder backbone [arXiv:2212.04356].

A port of ``repro.models.encdec``. As there, the mel-spectrogram and conv
feature extractor is a stub: the model takes precomputed frame embeddings
``[B, n_audio_frames, d_model]``. The backbone: a bidirectional encoder
(sinusoidal positions, no RoPE), a causal decoder with cross-attention to
the encoder's states (learned positions that wrap at ``max_target_len``,
the JAX package's own shape exercise), pre-LayerNorm blocks, GELU MLPs,
and the token embedding tied to the head.

``EncDec`` is an ``nn.Module`` whose ``enc_layers`` and ``dec_layers``
are lists of blocks where the JAX package stacks them for ``lax.scan``;
``repro_torch.convert.encdec_params_from_numpy`` unstacks its leaves onto
it. Parameters are fp32 masters and activations run in ``cfg.dtype``, as
in ``models.transformer``; with ``cfg.remat`` each block of a forward
under grad runs under ``torch.utils.checkpoint``. Attention takes the
JAX package's branches: the encoder's 1,500 frames the direct one, a
decoder of 2,048 tokens or more the flash kernel, causal for its own
tokens and non-causal against the encoder's frames.

The decode cache is ``{"self": [ring KV cache a layer], "cross": [{"k",
"v"} a layer]}``: the JAX package broadcasts one empty self cache over the
layers, but ``attention_decode`` writes its cache in place, so each layer
gets storage of its own. ``encdec_decode`` updates the self caches in
place.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import attention as attn
from .layers import GeluMLP, LayerNorm, gelu_mlp, layernorm, sinusoidal_positions
from .module import Embed, _device_of, dtype_of, token_nll, unembed
from ..sharding.act import constrain


class EncLayer(nn.Module):
    def __init__(self, cfg, generator: torch.Generator | None = None):
        super().__init__()
        dev = _device_of(generator)
        self.ln1 = LayerNorm(cfg.d_model, device=dev)
        self.attn = attn.Attention(cfg, generator)
        self.ln2 = LayerNorm(cfg.d_model, device=dev)
        self.mlp = GeluMLP(cfg.d_model, cfg.d_ff, generator)


class DecLayer(nn.Module):
    def __init__(self, cfg, generator: torch.Generator | None = None):
        super().__init__()
        dev = _device_of(generator)
        self.ln1 = LayerNorm(cfg.d_model, device=dev)
        self.self_attn = attn.Attention(cfg, generator)
        self.ln2 = LayerNorm(cfg.d_model, device=dev)
        self.cross_attn = attn.Attention(cfg, generator)
        self.ln3 = LayerNorm(cfg.d_model, device=dev)
        self.mlp = GeluMLP(cfg.d_model, cfg.d_ff, generator)


class EncDec(nn.Module):
    """Weights drawn from ``generator`` with the JAX init's distributions,
    on the generator's device."""

    def __init__(self, cfg, generator: torch.Generator | None = None):
        super().__init__()
        if cfg.family != "audio":
            raise ValueError(f"{cfg.name} is of family {cfg.family!r}, not audio")
        self.cfg = cfg
        dev = _device_of(generator)
        n_enc = cfg.n_encoder_layers or cfg.n_layers
        self.enc_layers = nn.ModuleList(EncLayer(cfg, generator) for _ in range(n_enc))
        self.enc_ln = LayerNorm(cfg.d_model, device=dev)
        self.dec_layers = nn.ModuleList(DecLayer(cfg, generator)
                                        for _ in range(cfg.n_layers))
        self.dec_ln = LayerNorm(cfg.d_model, device=dev)
        self.tok_embed = Embed(cfg.vocab_size, cfg.d_model, generator)
        self.pos_embed = nn.Parameter(torch.empty(cfg.max_target_len, cfg.d_model,
                                                  device=dev))
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 1.0, generator=generator).mul_(0.01)


def _run(remat: bool, fn, *args):
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _enc_block(layer: EncLayer, h, cfg):
    h = h + attn.attention_forward(layer.attn, layernorm(layer.ln1, h, cfg.norm_eps),
                                   cfg, causal=False, use_rope=False)
    return h + gelu_mlp(layer.mlp, layernorm(layer.ln2, h, cfg.norm_eps))


def encode(model: EncDec, frames: torch.Tensor, cfg) -> torch.Tensor:
    """frames: [B, F, d_model] stub embeddings -> encoder states [B, F, d]
    in ``cfg.dtype``."""
    dt = dtype_of(cfg)
    pe = sinusoidal_positions(frames.shape[1], cfg.d_model, frames.device)
    x = constrain(frames.to(dt) + pe.to(dt), "batch", None, None)
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in model.enc_layers:
        x = _run(remat, _enc_block, layer, constrain(x, "batch", "seq_tp", None), cfg)
    return layernorm(model.enc_ln, x, cfg.norm_eps)


def _dec_positions(model: EncDec, positions: torch.Tensor, dt) -> torch.Tensor:
    """The learned positions, wrapping beyond ``max_target_len``."""
    table = model.pos_embed
    return table[torch.remainder(positions, table.shape[0])].to(dt)


def _dec_block(layer: DecLayer, h, enc_out, cfg, window):
    h = h + attn.attention_forward(layer.self_attn,
                                   layernorm(layer.ln1, h, cfg.norm_eps),
                                   cfg, causal=True, window=window, use_rope=False)
    h = h + attn.attention_forward(layer.cross_attn,
                                   layernorm(layer.ln2, h, cfg.norm_eps),
                                   cfg, causal=False, use_rope=False, kv_x=enc_out)
    return h + gelu_mlp(layer.mlp, layernorm(layer.ln3, h, cfg.norm_eps))


def decode_train(model: EncDec, tokens: torch.Tensor, enc_out: torch.Tensor, cfg, *,
                 window: Optional[int] = None, last_only: bool = False) -> torch.Tensor:
    """Teacher-forced decoder: tokens [B, T] -> logits [B, T, V] fp32 (the
    last position's alone, [B, 1, V], with ``last_only``)."""
    dt = dtype_of(cfg)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    x = model.tok_embed(tokens, dt) + _dec_positions(model, pos, dt)[None]
    x = constrain(x, "batch", None, None)
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in model.dec_layers:
        x = _run(remat, _dec_block, layer, constrain(x, "batch", "seq_tp", None),
                 enc_out, cfg, window)
    if last_only:
        x = x[:, -1:]
    x = layernorm(model.dec_ln, x, cfg.norm_eps)
    return unembed(model.tok_embed.table, x)


def encdec_loss(model: EncDec, batch: dict, cfg) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy of the decoder over ``batch["tokens"]``
    given ``batch["frames"]``; labels < 0 are masked out."""
    enc_out = encode(model, batch["frames"], cfg)
    logits = decode_train(model, batch["tokens"], enc_out, cfg)
    labels = batch["tokens"][:, 1:]
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = token_nll(logp, torch.clamp(labels, min=0))
    mask = (labels >= 0).to(torch.float32)
    loss = torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)
    return loss, {"xent": loss}


# ---------------------------------------------------------------- decode ----
def init_encdec_cache(model: EncDec, enc_out: torch.Tensor, cfg, batch: int,
                      cache_len: int) -> dict:
    """Empty self-attention ring caches, one a decoder layer, and each
    layer's cross K/V of ``enc_out``, on ``enc_out``'s device (which may
    be ``meta``)."""
    dt = dtype_of(cfg)
    return {"self": [attn.make_kv_cache(cfg, batch, cache_len, dt, enc_out.device)
                     for _ in model.dec_layers],
            "cross": [attn.make_cross_cache(layer.cross_attn, enc_out, cfg)
                      for layer in model.dec_layers]}


def encdec_decode(model: EncDec, token: torch.Tensor, cache: dict, pos: int, cfg
                  ) -> tuple[torch.Tensor, dict]:
    """One decode step. token: [B, 1] int; pos: int. Returns (logits
    [B, 1, V] fp32, cache), the self caches updated in place."""
    dt = dtype_of(cfg)
    p = torch.full((1,), int(pos), dtype=torch.int64, device=token.device)
    x = model.tok_embed(token, dt) + _dec_positions(model, p, dt)[None]
    x = constrain(x, "batch", None, None)
    for layer, kv, cross in zip(model.dec_layers, cache["self"], cache["cross"]):
        y, _ = attn.attention_decode(layer.self_attn,
                                     layernorm(layer.ln1, x, cfg.norm_eps),
                                     kv, pos, cfg, use_rope=False)
        x = x + y
        x = x + attn.cross_attention_decode(layer.cross_attn,
                                            layernorm(layer.ln2, x, cfg.norm_eps),
                                            cross, cfg)
        x = x + gelu_mlp(layer.mlp, layernorm(layer.ln3, x, cfg.norm_eps))
    x = layernorm(model.dec_ln, x, cfg.norm_eps)
    return unembed(model.tok_embed.table, x), cache
