"""Single-host training CLI: the port of ``repro.launch.train``.

Runs real AdamW steps (``launch.steps.build_train_step``) on synthetic
Markov-chain tokens (``data.make_token_stream``): reduced configs on the
CPU, full ones on the card. The device is the GPU unless ``--device cpu``
is given; nothing falls back to the CPU.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --smoke --steps 20 --batch 8 --seq 256 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --steps 10 --batch 2 --seq 4096
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \\
        --smoke --steps 20 --device cpu        # also phi-3-vision-4.2b

Weights come from ``steps.init_for(cfg)`` with a generator seeded 0 on the
device. ``--ckpt-dir`` saves the parameters at the end in the JAX
package's checkpoint layout (``convert.model_params_to_numpy``: stacked
layer leaves), so either package's CLI resumes from the other's;
``--resume`` restores the newest valid one and continues the token stream
at its step. The VLM's batches carry zero ``extra_embeds`` and the audio
family's seeded normal ``frames``, as the reference's do.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..checkpoint import (latest_checkpoint, load_metadata, restore_checkpoint,
                          save_checkpoint)
from ..configs import ARCH_IDS, get_config, get_smoke
from ..convert import model_params_from_numpy, model_params_to_numpy
from ..data import make_token_stream
from ..devices import resolve_device
from ..models import param_count
from ..optim import adamw_init
from . import steps as steps_mod


def make_lm_batches(cfg, batch: int, seq: int, steps: int, seed: int = 0,
                    start_step: int = 0, device=None):
    """Batches for steps [start_step, start_step + steps) of the stream —
    a resumed run continues the token stream where it left off instead of
    retraining on the prefix. Each is ``{"tokens": [batch, seq] int32}`` on
    ``device`` (None: the GPU); the VLM's also ``"extra_embeds"``, zeros
    ``[batch, n_vision_tokens, d_model]``, and the audio family's
    ``"frames"`` ``[batch, n_audio_frames, d_model]``, standard normals
    from ``np.random.default_rng(seed + step)`` (fp32)."""
    dev = resolve_device(device)
    total = start_step + steps
    toks = make_token_stream(batch * (seq + 1) * total + 1, cfg.vocab_size, seed)
    for i in range(start_step, total):
        start = i * batch * (seq + 1)
        chunk = toks[start:start + batch * (seq + 1)].reshape(batch, seq + 1)
        b = {"tokens": torch.as_tensor(chunk[:, :seq], device=dev)}
        if cfg.family == "vlm":
            b["extra_embeds"] = torch.zeros((batch, cfg.n_vision_tokens, cfg.d_model),
                                            device=dev)
        if cfg.family == "audio":
            frames = np.random.default_rng(seed + i).normal(
                size=(batch, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
            b = {"frames": torch.as_tensor(frames, device=dev), "tokens": b["tokens"]}
        yield b


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="resume params from the newest VALID checkpoint in "
                         "--ckpt-dir (corrupt/truncated candidates are "
                         "skipped with a warning; see repro_torch.checkpoint)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    if args.resume and not args.ckpt_dir:
        ap.error("--resume requires --ckpt-dir")
    return args


def main(argv=None) -> list:
    """Train; returns the losses."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "vlm":
        args.seq = max(args.seq, cfg.n_vision_tokens + 32)

    model = steps_mod.init_for(cfg)(torch.Generator(device=dev).manual_seed(0))
    start_step = 0
    if args.resume:
        path = latest_checkpoint(args.ckpt_dir)
        if path is None:
            print(f"--resume: no valid checkpoint in {args.ckpt_dir}; "
                  "starting fresh")
        else:
            like = model_params_to_numpy(dict(model.named_parameters()), cfg)
            tree = restore_checkpoint(path, like)
            meta = load_metadata(path)
            if meta.get("arch", args.arch) != args.arch:
                raise SystemExit(f"checkpoint {path} is for arch "
                                 f"{meta['arch']!r}, not {args.arch!r}")
            model.load_state_dict(model_params_from_numpy(tree, cfg, dev))
            start_step = int(meta.get("step", 0))
            print(f"resumed {path} (step {start_step})")
    params = dict(model.named_parameters())
    print(f"{args.arch}: {param_count(params)/1e6:.1f}M params ({cfg.family})")
    opt_state = adamw_init(params)
    step_fn = steps_mod.build_train_step(cfg, lr=args.lr)

    losses = []
    t0 = time.time()
    for i, batch in enumerate(make_lm_batches(cfg, args.batch, args.seq,
                                              args.steps, start_step=start_step,
                                              device=dev)):
        model, opt_state, loss = step_fn(model, opt_state, batch)
        losses.append(float(loss))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {start_step + i:4d} loss {losses[-1]:.4f} "
                  f"({time.time()-t0:.1f}s)")
    if not np.isfinite(losses).all():
        raise AssertionError("NaN/inf loss")
    if start_step == 0 and not losses[-1] < losses[0]:
        # a short resumed continuation on fresh stream data can wiggle
        # up; the monotone check is a fresh-run smoke assertion
        raise AssertionError(f"no learning: {losses[0]} -> {losses[-1]}")
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} over {args.steps} steps")
    if args.ckpt_dir:
        end = start_step + args.steps
        print("saved:", save_checkpoint(
            args.ckpt_dir, end, model_params_to_numpy(params, cfg),
            {"arch": args.arch, "step": end, "loss": losses[-1]}))
    return losses


if __name__ == "__main__":
    main()
