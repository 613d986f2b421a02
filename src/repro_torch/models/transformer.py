"""Decoder-only LMs of the dense, vlm, moe, ssm and hybrid families.

A port of ``repro.models.transformer``:

  dense   GQA attention + SwiGLU        (tinyllama, qwen2.5-32b, glm4-9b,
                                         qwen2-72b)
  vlm     the dense stack + ``vision_proj``, a bias-free dense layer that
          projects stub patch embeddings (``extra_embeds``), prepended to
          the token embeddings (phi-3-vision)
  moe     GQA attention + MoE FFN       (qwen2-moe, mixtral-8x22b)
  ssm     RWKV6 time mix + channel mix  (rwkv6-1.6b)
  hybrid  Mamba2 layers + ONE shared attention block (its parameters
          shared) applied after every ``attn_every`` of them (zamba2)

The audio family (whisper) is the encoder-decoder of ``models.encdec``.
The LM is an ``nn.Module`` whose ``layers`` is a list of blocks where the
JAX package stacks them for ``lax.scan``; ``repro_torch.convert`` unstacks
the JAX package's leaves onto it.

Parameters are fp32 masters; activations run in ``cfg.dtype``, each dense
weight, expert stack and the embedding table cast per call, as the JAX
package's ``dense``/``embed``/``moe_forward`` do, so training's gradients
land on the fp32 parameters. ``for_compute(model, cfg)`` gives a serving
copy whose leaves that are cast per call are already in that type (the
same bits as the per-call cast); the rest stays fp32 (the router, norms,
RWKV's ``mu``/``w0``/``wA``/``wB``/``u``, Mamba2's ``conv_w``/``conv_b``/
``A_log``/``dt_bias``/``D``, the head). With ``cfg.remat`` each block of a
forward under grad runs under ``torch.utils.checkpoint`` (non-reentrant),
as the JAX package's ``jax.checkpoint`` of the scanned block: the hybrid
checkpoints each Mamba layer, and the shared block once a group.

Caches are per-layer lists where the JAX package stacks: ``{"layers":
[ring KV cache]}`` (dense, moe), ``{"layers": [{"shift", "state",
"ffn_shift"}]}`` (ssm), ``{"layers": [{"conv", "state"}], "shared_attn":
[ring KV cache a group]}`` (hybrid). ``lm_decode`` updates the cache dict
in place.
"""
from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import attention as attn
from .layers import LayerNorm, RMSNorm, SwiGLU, layernorm, rmsnorm, swiglu
from .module import Dense, Embed, _device_of, dtype_of, token_nll, unembed
from .moe import MoE, moe_forward
from .rwkv import RWKV6, RWKVFFN, make_rwkv_cache, rwkv6_decode, rwkv6_forward, rwkv_ffn
from .ssm import Mamba2, make_ssm_cache, mamba2_decode, mamba2_forward
from ..sharding.act import constrain

# every model family of the configs: the LM's, and the encoder-decoder's
FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


def check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r} ({cfg.name})")


def check_lm_family(cfg) -> None:
    """``check_family``, and the family is an LM's (not the audio
    encoder-decoder's, ``models.encdec``)."""
    check_family(cfg)
    if cfg.family == "audio":
        raise ValueError(f"{cfg.name} is of family 'audio': an encoder-decoder "
                         "(models.encdec.EncDec), not an LM")


class DenseBlock(nn.Module):
    def __init__(self, cfg, generator: torch.Generator | None = None):
        super().__init__()
        dev = _device_of(generator)
        self.ln1 = RMSNorm(cfg.d_model, device=dev)
        self.attn = attn.Attention(cfg, generator)
        self.ln2 = RMSNorm(cfg.d_model, device=dev)
        self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, generator)


class MoEBlock(nn.Module):
    def __init__(self, cfg, generator: torch.Generator | None = None):
        super().__init__()
        dev = _device_of(generator)
        self.ln1 = RMSNorm(cfg.d_model, device=dev)
        self.attn = attn.Attention(cfg, generator)
        self.ln2 = RMSNorm(cfg.d_model, device=dev)
        self.moe = MoE(cfg, generator)


class RWKVBlock(nn.Module):
    def __init__(self, cfg, generator: torch.Generator | None = None):
        super().__init__()
        dev = _device_of(generator)
        self.ln1 = LayerNorm(cfg.d_model, device=dev)
        self.time = RWKV6(cfg, generator)
        self.ln2 = LayerNorm(cfg.d_model, device=dev)
        self.ffn = RWKVFFN(cfg, generator)


class MambaBlock(nn.Module):
    def __init__(self, cfg, generator: torch.Generator | None = None):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, device=_device_of(generator))
        self.mamba = Mamba2(cfg, generator)


_BLOCKS = {"dense": DenseBlock, "vlm": DenseBlock, "moe": MoEBlock,
           "ssm": RWKVBlock, "hybrid": MambaBlock}


class LM(nn.Module):
    """Weights drawn from ``generator`` with the JAX init's distributions,
    on the generator's device."""

    def __init__(self, cfg, generator: torch.Generator | None = None):
        super().__init__()
        check_lm_family(cfg)
        self.cfg = cfg
        dev = _device_of(generator)
        self.embed = Embed(cfg.vocab_size, cfg.d_model, generator)
        self.ln_f = (LayerNorm if cfg.family == "ssm" else RMSNorm)(cfg.d_model,
                                                                    device=dev)
        block = _BLOCKS[cfg.family]
        self.layers = nn.ModuleList(block(cfg, generator) for _ in range(cfg.n_layers))
        if cfg.family == "hybrid":
            if not cfg.attn_every or cfg.n_layers % cfg.attn_every:
                raise ValueError(f"{cfg.n_layers} layers are not groups of "
                                 f"attn_every = {cfg.attn_every}")
            self.shared_attn = DenseBlock(cfg, generator)
        if not cfg.tie_embeddings:
            self.lm_head = Embed(cfg.vocab_size, cfg.d_model, generator)
        if cfg.family == "vlm":
            self.vision_proj = Dense(cfg.d_model, cfg.d_model, bias=False, device=dev)
            self.vision_proj.reset_parameters(generator)

    def head(self) -> torch.Tensor:
        return self.embed.table if self.cfg.tie_embeddings else self.lm_head.table

    def groups(self):
        """The hybrid's Mamba layers in groups of ``attn_every``."""
        k = self.cfg.attn_every
        return [self.layers[i:i + k] for i in range(0, len(self.layers), k)]


def _per_call_casts(model: LM, cfg) -> list:
    """(module, parameter name) of every leaf the JAX package casts to the
    activation's type per call: each dense weight and bias but the MoE
    router's, the expert stacks, and the embedding table unless it is tied
    (then it is also the fp32 head)."""
    routers = {id(m.router) for m in model.modules() if isinstance(m, MoE)}
    out = []
    for m in model.modules():
        if isinstance(m, Dense) and id(m) not in routers:
            out += [(m, "w")] + ([(m, "b")] if m.b is not None else [])
        elif isinstance(m, MoE):
            out += [(m, "w_gate"), (m, "w_up"), (m, "w_down")]
    if not cfg.tie_embeddings:
        out.append((model.embed, "table"))
    return out


def for_compute(model: LM, cfg, *, inplace: bool = False) -> LM:
    """A serving copy of ``model``: each leaf the JAX package casts per
    call (``_per_call_casts``) cast to ``cfg.dtype`` once, every other leaf
    fp32. ``model`` itself when those leaves are already in that type (an
    fp32 model, or a serving copy). ``inplace`` casts ``model``'s own
    leaves, one at a time, and returns it: the fp32 master and a full copy
    are never on the device together (qwen2-moe's 57 GB of fp32 masters and
    its 28.6 GB copy would not fit an 80 GB card)."""
    dt = dtype_of(cfg)
    leaves = _per_call_casts(model, cfg)
    if all(getattr(m, n).dtype == dt for m, n in leaves):
        return model
    if not inplace:
        # the copy takes each cast leaf from memo: no fp32 duplicate of it
        memo = {}
        for m, n in leaves:
            p = getattr(m, n)
            memo[id(p)] = nn.Parameter(p.detach().to(dt), requires_grad=p.requires_grad)
        return copy.deepcopy(model, memo)
    with torch.no_grad():
        for m, n in leaves:
            p = getattr(m, n)
            p.data = p.data.to(dt)
    return model


def _dense_block(layer: DenseBlock, x, cfg, window):
    x = x + attn.attention_forward(layer.attn, rmsnorm(layer.ln1.scale, x, cfg.norm_eps),
                                   cfg, window=window)
    return x + swiglu(layer.mlp, rmsnorm(layer.ln2.scale, x, cfg.norm_eps))


def _moe_block(layer: MoEBlock, x, cfg, window):
    x = x + attn.attention_forward(layer.attn, rmsnorm(layer.ln1.scale, x, cfg.norm_eps),
                                   cfg, window=window)
    y, aux = moe_forward(layer.moe, rmsnorm(layer.ln2.scale, x, cfg.norm_eps), cfg)
    return x + y, aux


def _rwkv_block(layer: RWKVBlock, x, cfg):
    x = x + rwkv6_forward(layer.time, layernorm(layer.ln1, x, cfg.norm_eps), cfg)
    return x + rwkv_ffn(layer.ffn, layernorm(layer.ln2, x, cfg.norm_eps))


def _mamba_block(layer: MambaBlock, x, cfg):
    return x + mamba2_forward(layer.mamba, rmsnorm(layer.ln.scale, x, cfg.norm_eps), cfg)


def _final_norm(model: LM, x, cfg):
    if cfg.family == "ssm":
        return layernorm(model.ln_f, x, cfg.norm_eps)
    return rmsnorm(model.ln_f.scale, x, cfg.norm_eps)


def _embed(model: LM, tokens, cfg, extra_embeds):
    """The token embeddings, after the projected ``extra_embeds`` (vlm:
    [B, S_vis, d]) when given."""
    dt = dtype_of(cfg)
    x = model.embed(tokens, dt)
    if extra_embeds is None:
        return x
    return torch.cat([model.vision_proj(extra_embeds.to(dt)), x], dim=1)


def lm_forward(model: LM, tokens: torch.Tensor, cfg, *,
               extra_embeds: Optional[torch.Tensor] = None,
               window: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens: [B, S_text] int; extra_embeds (vlm): [B, S_vis, d]
    prepended. Returns (logits [B,S,V] fp32, aux loss: the MoE layers'
    load-balance losses summed, else 0)."""
    check_lm_family(cfg)
    x = constrain(_embed(model, tokens, cfg, extra_embeds), "batch", None, None)
    if window is None:
        window = cfg.sliding_window
    remat = cfg.remat and torch.is_grad_enabled()

    def run(fn, *args):
        if remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def block_in(h):
        return constrain(h, "batch", "seq_tp", None)

    auxs = []
    fam = cfg.family
    if fam in ("dense", "vlm"):
        for layer in model.layers:
            x = run(_dense_block, layer, block_in(x), cfg, window)
    elif fam == "moe":
        for layer in model.layers:
            x, aux = run(_moe_block, layer, block_in(x), cfg, window)
            auxs.append(aux)
    elif fam == "ssm":
        for layer in model.layers:
            x = run(_rwkv_block, layer, block_in(x), cfg)
    else:                                           # hybrid
        for group in model.groups():
            x = block_in(x)                         # a group's input
            for layer in group:
                x = run(_mamba_block, layer, x, cfg)
            x = run(_dense_block, model.shared_attn, x, cfg, window)
    x = _final_norm(model, x, cfg)
    aux = (torch.stack(auxs).sum() if auxs
           else torch.zeros((), device=x.device))
    return constrain(unembed(model.head(), x), "batch", None, "vocab"), aux


def lm_loss(model: LM, batch: dict, cfg) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy. batch: {"tokens": [B,S]} (+ optional
    "extra_embeds" [B,S_vis,d], whose positions' logits are dropped, and
    "labels" [B,S], whose entries < 0 are masked out). Without labels the
    labels are ``tokens[:, 1:]`` against the logits of positions 0..S-2.
    Returns (loss + aux, {"xent": loss, "aux": aux})."""
    tokens = batch["tokens"]
    extra = batch.get("extra_embeds")
    logits, aux = lm_forward(model, tokens, cfg, extra_embeds=extra)
    if extra is not None:
        logits = logits[:, extra.shape[1]:]                 # the text region
    labels = batch.get("labels")
    if labels is None:
        labels = tokens[:, 1:]
        logits = logits[:, :-1]
    mask = (labels >= 0).to(torch.float32)
    lab = torch.clamp(labels, min=0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = token_nll(logp, lab)
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return loss + aux, {"xent": loss, "aux": aux}


def _attn_prefill(block, x, cfg, window, cache_len, dt):
    """An attention block's prefill: (x, its ring KV cache). The block's
    FFN is its SwiGLU, or its MoE (the aux loss dropped)."""
    y, (k, v) = attn.attention_forward(
        block.attn, rmsnorm(block.ln1.scale, x, cfg.norm_eps), cfg,
        window=window, return_kv=True)
    x = x + y
    h = rmsnorm(block.ln2.scale, x, cfg.norm_eps)
    x = x + (moe_forward(block.moe, h, cfg)[0] if isinstance(block, MoEBlock)
             else swiglu(block.mlp, h))
    return x, attn.fill_kv_cache(k, v, cache_len, dt)


def lm_prefill(model: LM, tokens: torch.Tensor, cfg, *, cache_len: int,
               extra_embeds: Optional[torch.Tensor] = None,
               window: Optional[int] = None) -> tuple[torch.Tensor, dict]:
    """Serving prefill: the forward pass that also builds the decode cache
    (ring KV caches, RWKV and Mamba2 states); extra_embeds (vlm) as in
    ``lm_forward``. Returns (last-token logits [B,1,V], cache)."""
    check_lm_family(cfg)
    dt = dtype_of(cfg)
    x = constrain(_embed(model, tokens, cfg, extra_embeds), "batch", None, None)
    if window is None:
        window = cfg.sliding_window
    caches = []
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        for layer in model.layers:
            x, kv = _attn_prefill(layer, constrain(x, "batch", "seq_tp", None),
                                  cfg, window, cache_len, dt)
            caches.append(kv)
        cache = {"layers": caches}
    elif fam == "ssm":
        for layer in model.layers:
            y, st = rwkv6_forward(layer.time, layernorm(layer.ln1, x, cfg.norm_eps),
                                  cfg, return_state=True)
            x = x + y
            ln2 = layernorm(layer.ln2, x, cfg.norm_eps)
            x = x + rwkv_ffn(layer.ffn, ln2)
            caches.append(dict(st, ffn_shift=ln2[:, -1:, :]))
        cache = {"layers": caches}
    else:                                           # hybrid
        kvs = []
        for group in model.groups():
            for layer in group:
                y, st = mamba2_forward(layer.mamba,
                                       rmsnorm(layer.ln.scale, x, cfg.norm_eps),
                                       cfg, return_state=True)
                x = x + y
                caches.append(st)
            x, kv = _attn_prefill(model.shared_attn, x, cfg, window, cache_len, dt)
            kvs.append(kv)
        cache = {"layers": caches, "shared_attn": kvs}
    x = _final_norm(model, x[:, -1:], cfg)
    return unembed(model.head(), x), cache


def init_lm_cache(cfg, batch: int, cache_len: int, device=None) -> dict:
    """Empty per-layer caches (``device`` may be ``meta``)."""
    check_lm_family(cfg)
    dt = dtype_of(cfg)

    def kv():
        return attn.make_kv_cache(cfg, batch, cache_len, dt, device)
    if cfg.family in ("dense", "vlm", "moe"):
        return {"layers": [kv() for _ in range(cfg.n_layers)]}
    if cfg.family == "ssm":
        return {"layers": [make_rwkv_cache(cfg, batch, dt, device)
                           for _ in range(cfg.n_layers)]}
    return {"layers": [make_ssm_cache(cfg, batch, dt, device)
                       for _ in range(cfg.n_layers)],
            "shared_attn": [kv() for _ in range(cfg.n_layers // cfg.attn_every)]}


def _attn_decode(block, x, kv, pos, cfg):
    y, _ = attn.attention_decode(block.attn, rmsnorm(block.ln1.scale, x, cfg.norm_eps),
                                 kv, pos, cfg)
    x = x + y
    h = rmsnorm(block.ln2.scale, x, cfg.norm_eps)
    return x + (moe_forward(block.moe, h, cfg)[0] if isinstance(block, MoEBlock)
                else swiglu(block.mlp, h))


def lm_decode(model: LM, token: torch.Tensor, cache: dict, pos: int, cfg
              ) -> tuple[torch.Tensor, dict]:
    """One decode step. token: [B,1] int; pos: int. Returns (logits
    [B,1,V], cache), the cache updated in place."""
    check_lm_family(cfg)
    x = constrain(model.embed(token, dtype_of(cfg)), "batch", None, None)
    fam = cfg.family
    layers = cache["layers"]
    if fam in ("dense", "vlm", "moe"):
        for layer, kv in zip(model.layers, layers):
            x = _attn_decode(layer, x, kv, pos, cfg)
    elif fam == "ssm":
        for i, layer in enumerate(model.layers):
            y, c = rwkv6_decode(layer.time, layernorm(layer.ln1, x, cfg.norm_eps),
                                layers[i], cfg)
            x = x + y
            ffn_in = layernorm(layer.ln2, x, cfg.norm_eps)
            x = x + rwkv_ffn(layer.ffn, ffn_in, prev=c["ffn_shift"])
            layers[i] = dict(c, ffn_shift=ffn_in)
    else:                                           # hybrid
        i = 0
        for group, kv in zip(model.groups(), cache["shared_attn"]):
            for layer in group:
                y, layers[i] = mamba2_decode(layer.mamba,
                                             rmsnorm(layer.ln.scale, x, cfg.norm_eps),
                                             layers[i], cfg)
                x = x + y
                i += 1
            x = _attn_decode(model.shared_attn, x, kv, pos, cfg)
    x = _final_norm(model, x, cfg)
    return unembed(model.head(), x), cache
