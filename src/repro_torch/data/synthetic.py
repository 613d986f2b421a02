"""Synthetic FMNIST-like data and LM token streams (the port's numpy
copies of the JAX package's).

``make_fmnist_like`` builds a 10-class, 28x28 grayscale dataset with
class-conditional structure (smoothed class prototypes + per-sample
deformation + noise) so that CNN training shows genuine learning curves and
non-IID Dirichlet splits behave like the paper's FMNIST experiments. The
numpy calls are the reference's, so both packages see identical images.
"""
from __future__ import annotations

import numpy as np


def _smooth(img: np.ndarray, iters: int = 2) -> np.ndarray:
    for _ in range(iters):
        img = (img
               + np.roll(img, 1, 0) + np.roll(img, -1, 0)
               + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 5.0
    return img


def make_fmnist_like(n_samples: int = 20000, n_classes: int = 10,
                     hw: tuple[int, int] = (28, 28), seed: int = 0,
                     noise: float = 0.35, proto_seed: int = 1234,
                     confusion: float = 0.0, label_noise: float = 0.0):
    """Returns (images [N,H,W,1] float32, labels [N] int32).

    Class prototypes come from ``proto_seed`` (fixed across train/test
    splits); ``seed`` only controls sample draws. ``confusion`` blends each
    sample with a random other class prototype and ``label_noise`` flips
    that fraction of labels — together they set a realistic accuracy
    ceiling.
    """
    rng = np.random.default_rng(seed)
    proto_rng = np.random.default_rng(proto_seed)
    H, W = hw
    protos = np.stack([_smooth(proto_rng.normal(size=(H, W)), 3) for _ in range(n_classes)])
    protos = (protos - protos.mean((1, 2), keepdims=True)) / protos.std((1, 2), keepdims=True)

    labels = rng.integers(0, n_classes, size=n_samples).astype(np.int32)
    shifts_r = rng.integers(-2, 3, size=n_samples)
    shifts_c = rng.integers(-2, 3, size=n_samples)
    scales = rng.uniform(0.8, 1.2, size=n_samples).astype(np.float32)
    imgs = np.empty((n_samples, H, W, 1), np.float32)
    for i in range(n_samples):
        img = np.roll(protos[labels[i]], (shifts_r[i], shifts_c[i]), axis=(0, 1))
        if confusion > 0:
            other = (labels[i] + rng.integers(1, n_classes)) % n_classes
            w = rng.uniform(0.0, confusion)
            img = (1 - w) * img + w * np.roll(
                protos[other], (shifts_r[i], shifts_c[i]), axis=(0, 1))
        img = scales[i] * img + noise * rng.normal(size=(H, W))
        imgs[i, :, :, 0] = img
    if label_noise > 0:
        flip = rng.random(n_samples) < label_noise
        labels[flip] = rng.integers(0, n_classes, flip.sum())
    return imgs.astype(np.float32), labels


def make_token_stream(n_tokens: int, vocab_size: int, seed: int = 0,
                      order: int = 2) -> np.ndarray:
    """Synthetic LM data: a sparse random Markov chain, so next-token loss
    is genuinely reducible below log(V). The numpy calls are the
    reference's, so both packages see identical ids."""
    rng = np.random.default_rng(seed)
    n_states = min(vocab_size, 512)
    trans = rng.integers(0, n_states, size=(n_states, 8))
    toks = np.empty(n_tokens, np.int32)
    s = 0
    for i in range(n_tokens):
        s = int(trans[s, rng.integers(0, 8)])
        toks[i] = s
    return toks
