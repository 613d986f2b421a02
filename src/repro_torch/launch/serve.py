"""Single-host serving driver: prefill a prompt batch, then decode tokens.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --prompt-len 2048 --gen 32 --batch 4            # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --smoke --prompt-len 64 --gen 8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
      --prompt-len 2048 --gen 32 --batch 4            # also qwen2-moe-a2.7b,
                                                      # zamba2-2.7b, mixtral-8x22b,
                                                      # phi-3-vision-4.2b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
      --gen 32 --batch 4

The port of ``repro.launch.serve``, with its flow and its printed line.
One seed keys the weights, the prompt and the sampling, as one PRNG key
does in the JAX package: the prompt ids (``random.randint``) are the JAX
package's bit for bit under ``jax.threefry_partitionable(False)``, and so
are the sampling keys (``key, sk = split(key)`` at each step) and the
uniforms under ``random.categorical``'s Gumbel noise (its ``log`` may
round an ulp apart, ROADMAP C-9); the weights are drawn from a
``torch.Generator`` seeded with it (``repro_torch.convert`` loads the JAX
package's). The first token after prefill is the argmax at any
temperature, and decode step i runs at position ``prompt_len + i``, as in
the reference. The audio family (whisper) follows the reference's own
flow: frames ``normal(key, (batch, n_audio_frames, d_model))`` drawn from
the same key as the prompt, the encoder's states and an empty self cache
of ``prompt_len + gen`` slots (no prefill: the prompt is drawn but not
read), then decode from token 0 at position 0. The VLM serves through the
dense flow, without vision embeddings, as the reference's does (its
vision path is ``steps.build_prefill_step``). The device is the GPU
unless ``--device cpu`` is given. The CLI casts its freshly drawn fp32
weights to the serving type in place (``transformer.for_compute(...,
inplace=True)``), so the fp32 masters and a serving copy are never on the
card together: qwen2-moe-a2.7b's 57 GB of masters and 28.6 GB copy would
not fit an 80 GB card.
fp32 matmuls on the card must run in full float32
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default,
which ``chip_smoke.py`` also sets for its card-against-CPU check); the
port does not change that global setting itself.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import torch

from .. import random as prng
from ..configs import ARCH_IDS, get_config, get_smoke
from ..devices import resolve_device
from ..models import encdec
from ..models import transformer as tfm
from . import steps as steps_mod


@dataclass
class Generation:
    prompt: torch.Tensor             # [batch, prompt_len] int32 (host)
    ids: torch.Tensor                # [batch, 1 + gen] int32 (host): argmax
                                     # (audio: token 0), then samples
    first_logits: torch.Tensor | None  # [batch, V] fp32: the prefill's last
                                       # position (audio: None, no prefill)
    decode_logits: list              # gen x [batch, V] fp32, one per decode step
    prefill_s: float
    decode_s: float


def generate(cfg, params, *, prompt_len: int, gen: int, batch: int,
             temperature: float = 1.0, seed: int = 0, device=None) -> Generation:
    """Prefill ``batch`` prompts of ``prompt_len`` random ids, then decode
    ``gen`` tokens each against a ring cache of ``prompt_len + gen`` slots.
    ``params`` is the model (``steps.init_for(cfg)``) on ``device``; it
    runs in ``cfg.dtype`` through a serving copy
    (``transformer.for_compute``), or as given when it is one already."""
    dev = resolve_device(device)
    model = tfm.for_compute(params, cfg)
    key = prng.PRNGKey(seed)
    cache_len = prompt_len + gen
    prompt = prng.randint(key, (batch, prompt_len), 0, cfg.vocab_size)

    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        if cfg.family == "audio":
            frames = prng.normal(key, (batch, cfg.n_audio_frames, cfg.d_model))
            enc = encdec.encode(model, frames.to(dev), cfg)
            cache = encdec.init_encdec_cache(model, enc, cfg, batch, cache_len)
            first, pos0, decode = None, 0, encdec.encdec_decode
            tok = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
        else:
            logits, cache = tfm.lm_prefill(model, prompt.to(dev), cfg,
                                           cache_len=cache_len)
            first, pos0, decode = logits[:, -1], prompt_len, tfm.lm_decode
            tok = torch.argmax(first, dim=-1)[:, None].to(torch.int32)
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        toks, decode_logits = [tok], []
        t0 = time.perf_counter()
        for i in range(gen):
            logits, cache = decode(model, tok, cache, pos0 + i, cfg)
            last = logits[:, -1]
            decode_logits.append(last)
            if temperature > 0:
                key, sk = prng.split(key)
                tok = prng.categorical(sk, last / temperature)[:, None].to(torch.int32)
            else:
                tok = torch.argmax(last, dim=-1)[:, None].to(torch.int32)
            toks.append(tok)
        _sync(dev)
        t_decode = time.perf_counter() - t0
    return Generation(prompt=prompt, ids=torch.cat(toks, dim=1).cpu(),
                      first_logits=first, decode_logits=decode_logits,
                      prefill_s=t_prefill, decode_s=t_decode)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU, raising without one)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    params = steps_mod.init_for(cfg)(torch.Generator(dev).manual_seed(0))
    params = tfm.for_compute(params, cfg, inplace=True)
    out = generate(cfg, params, prompt_len=args.prompt_len, gen=args.gen,
                   batch=args.batch, temperature=args.temperature, seed=0,
                   device=dev)
    print(f"{args.arch}: prefill {args.prompt_len} tok in {out.prefill_s:.2f}s; "
          f"decoded {args.gen} tok in {out.decode_s:.2f}s "
          f"({args.gen * args.batch / max(out.decode_s, 1e-9):.1f} tok/s)")
    print("sampled ids (first request):", out.ids[0][:16].tolist(), "...")
    last = out.decode_logits[-1] if out.decode_logits else out.first_logits
    if last is not None and not bool(torch.isfinite(last).all()):
        raise RuntimeError("non-finite logits")


if __name__ == "__main__":
    main()
