"""Model-agnostic step functions and meta-device input specs.

  train_step  (model, opt_state, batch)  -> (model, opt_state, loss)
  prefill_step(model, batch)             -> (last logits, decode cache)
  serve_step  (model, cache, token, pos) -> (logits, cache)

Ports of ``repro.launch.steps`` for the CNN, every LM family (the MoE's
aux loss is in ``lm_loss``; the VLM's batch carries ``extra_embeds``) and
the audio encoder-decoder (``models.encdec``: a batch of ``frames`` and
``tokens``). The model is an ``nn.Module`` whose fp32 parameters the
train step updates in place (AdamW, ``optim.adamw``); the optimizer state
is a dict over the parameters' names. ``input_specs``, ``params_shape``
and ``opt_shape`` return tensors on the ``meta`` device (shapes and types,
no storage) where the JAX package returns ``ShapeDtypeStruct``s; a
decode's ``cache`` is the family's (ring KV caches, RWKV or Mamba2
states, or the encoder-decoder's self and cross caches).

The audio prefill step keeps the JAX package's flow: it encodes the
frames, runs the decoder over the prompt for the last position's logits,
and returns a fresh cache (empty self caches, the cross K/V), so decode
steps after it attend to the encoder's states and their own tokens, not
to the prompt's (ROADMAP C-25).
"""
from __future__ import annotations

import contextlib

import torch

from ..configs import SHAPES, get_config
from ..models import cnn, encdec
from ..models import transformer as tfm
from ..models.module import dtype_of
from ..optim import adamw_init, adamw_update
from ..sharding.act import microbatch

META = torch.device("meta")


def cache_len_for(cfg, shape) -> int:
    """Decode KV-cache length. Sliding-window archs cap at their window;
    full-attention archs cap at ``long_context_window`` for long_500k."""
    if cfg.sliding_window:
        return min(shape.seq_len, cfg.sliding_window)
    if shape.seq_len > 65536:
        return cfg.long_context_window
    return shape.seq_len


def loss_for(cfg):
    """``loss(model, batch) -> (loss, metrics)``."""
    if cfg.family == "cnn":
        return lambda model, b: cnn.cnn_loss(model)(dict(model.named_parameters()), b)
    tfm.check_family(cfg)
    if cfg.family == "audio":
        return lambda model, b: encdec.encdec_loss(model, b, cfg)
    return lambda model, b: tfm.lm_loss(model, b, cfg)


def init_for(cfg):
    """``init(generator) -> model``, its weights drawn from ``generator``
    on the generator's device."""
    if cfg.family == "cnn":
        return lambda generator: cnn.CNN(cfg, generator)
    tfm.check_family(cfg)
    if cfg.family == "audio":
        return lambda generator: encdec.EncDec(cfg, generator)
    return lambda generator: tfm.LM(cfg, generator)


def _meta_model(cfg):
    with META:
        return init_for(cfg)(None)


def params_shape(cfg) -> dict:
    """The model's parameters (name -> tensor) on the meta device."""
    return dict(_meta_model(cfg).named_parameters())


def opt_shape(p_sds: dict, moment_dtype=torch.float32) -> dict:
    """The AdamW state of ``p_sds`` on their (meta) device."""
    return adamw_init(p_sds, moment_dtype=moment_dtype)


# ----------------------------------------------------------- input specs ----
def input_specs(arch: str, shape_name: str, cfg=None) -> dict:
    """Meta-device stand-ins for the step function's data arguments."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    i32, dt = torch.int32, dtype_of(cfg)

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=META)
    if shape.kind in ("train", "prefill"):
        if cfg.family == "audio":
            return {"frames": empty((B, cfg.n_audio_frames, cfg.d_model), dt),
                    "tokens": empty((B, S), i32)}
        if cfg.family == "vlm":
            return {"tokens": empty((B, S - cfg.n_vision_tokens), i32),
                    "extra_embeds": empty((B, cfg.n_vision_tokens, cfg.d_model), dt)}
        return {"tokens": empty((B, S), i32)}
    # decode: one token against a seq_len-deep cache
    cl = cache_len_for(cfg, shape)
    if cfg.family == "audio":
        enc = empty((B, cfg.n_audio_frames, cfg.d_model), dt)
        cache = encdec.init_encdec_cache(_meta_model(cfg), enc, cfg, B, cl)
    else:
        cache = tfm.init_lm_cache(cfg, B, cl, device=META)
    return {"token": torch.empty((B, 1), dtype=i32, device=META),
            "cache": cache, "pos": torch.empty((), dtype=i32, device=META)}


# ------------------------------------------------------------ step fns ----
def build_train_step(cfg, *, lr: float = 3e-4, microbatches: int = 1,
                     counted_micro=None):
    """AdamW train step. With ``microbatches`` M > 1 the batch's rows split
    into M consecutive slices, each slice's loss back-propagated in turn
    and the gradients summed in fp32 (the parameters' ``.grad``, the JAX
    package's fp32 accumulator), then divided by M: the activations of one
    slice at a time. The loss returned is the mean of the slices'.

    ``counted_micro`` is for cost reports (``launch.dryrun``): a factory
    of the context manager that scales what it counts by M. With it the
    step runs the first slice's forward and backward alone, inside that
    context (the M slices have one shape), then the rest of the step
    once; its loss is the first slice's over M."""
    loss_fn = loss_for(cfg)
    M = microbatches
    scope = counted_micro or contextlib.nullcontext

    def micro(model, mb):
        with scope():
            li, _ = loss_fn(model, mb)
            li.backward()
        return li.detach()

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        if M == 1:
            loss = micro(model, batch)
        else:
            loss = None
            for i in range(1 if counted_micro else M):
                mb = {k: microbatch(t, M, i) for k, t in batch.items()}
                li = micro(model, mb)
                loss = li if loss is None else loss + li
            # true divisions (a CUDA tensor divided by a Python scalar is
            # multiplied by its reciprocal)
            m_t = torch.tensor(float(M), device=loss.device)
            for p in params.values():
                if p.grad is not None:
                    p.grad = torch.div(p.grad, m_t)
            loss = torch.div(loss, m_t)
        grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
                 for k, p in params.items()}
        adamw_update(grads, opt_state, params, lr)
        for p in params.values():
            p.grad = None
        return model, opt_state, loss
    return train_step


def build_prefill_step(cfg, shape):
    cl = cache_len_for(cfg, shape)

    if cfg.family == "audio":
        def prefill_step(model, batch):
            enc_out = encdec.encode(model, batch["frames"], cfg)
            logits = encdec.decode_train(model, batch["tokens"], enc_out, cfg,
                                         last_only=True)
            cache = encdec.init_encdec_cache(model, enc_out, cfg,
                                             batch["tokens"].shape[0], cl)
            return logits, cache
        return prefill_step

    def prefill_step(model, batch):
        return tfm.lm_prefill(model, batch["tokens"], cfg, cache_len=cl,
                              extra_embeds=batch.get("extra_embeds"))
    return prefill_step


def build_serve_step(cfg):
    if cfg.family == "audio":
        def serve_step(model, cache, token, pos):
            return encdec.encdec_decode(model, token, cache, pos, cfg)
        return serve_step

    def serve_step(model, cache, token, pos):
        return tfm.lm_decode(model, token, cache, pos, cfg)
    return serve_step
