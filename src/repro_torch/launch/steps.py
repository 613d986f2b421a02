"""Model-agnostic step builders of the serving path.

  prefill_step(model, batch)             -> (last logits, decode cache)
  serve_step  (model, cache, token, pos) -> (logits, cache)

Ports of ``repro.launch.steps`` for the CNN and the dense LM. The train
step, ``input_specs`` and the encoder-decoder (whisper) steps wait for
ROADMAP A-19.
"""
from __future__ import annotations

from ..models import cnn
from ..models import transformer as tfm


def _not_ported(cfg, what: str):
    raise NotImplementedError(f"{what} for family {cfg.family!r} is not "
                              "ported yet (ROADMAP A-19)")


def cache_len_for(cfg, shape) -> int:
    """Decode KV-cache length. Sliding-window archs cap at their window;
    full-attention archs cap at ``long_context_window`` for long_500k."""
    if cfg.sliding_window:
        return min(shape.seq_len, cfg.sliding_window)
    if shape.seq_len > 65536:
        return cfg.long_context_window
    return shape.seq_len


def init_for(cfg):
    """``init(generator) -> model``, its weights drawn from ``generator``
    on the generator's device."""
    if cfg.family == "cnn":
        return lambda generator: cnn.CNN(cfg, generator)
    tfm.check_family(cfg)
    return lambda generator: tfm.LM(cfg, generator)


def build_prefill_step(cfg, shape):
    if cfg.family == "audio":
        _not_ported(cfg, "the prefill step")
    cl = cache_len_for(cfg, shape)

    def prefill_step(model, batch):
        return tfm.lm_prefill(model, batch["tokens"], cfg, cache_len=cl)
    return prefill_step


def build_serve_step(cfg):
    if cfg.family == "audio":
        _not_ported(cfg, "the serve step")

    def serve_step(model, cache, token, pos):
        return tfm.lm_decode(model, token, cache, pos, cfg)
    return serve_step
