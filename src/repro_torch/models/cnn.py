"""The paper's FMNIST CNN (~1.6M parameters at full width, Sec. VII).

conv3x3(32) -> relu -> maxpool2 -> conv3x3(64) -> relu -> maxpool2 ->
flatten -> dense(512) -> relu -> dense(10). Parameters keep the JAX
package's names and layouts (``conv0.w`` HWIO, ``fc1.w`` ``[in, out]``,
see ``models.module``). Images arrive NHWC, as in the JAX package; the
convolutions run NCHW inside, and the features are flattened in HWC order
before ``fc1`` — the order the reference's NHWC reshape produces (a plain
NCHW flatten would scramble ``fc1``'s rows).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from .. import random as prng
from ..convert import params_from_numpy
from .module import Conv3x3, Dense


def init_cnn(key: torch.Tensor, cfg, device=None) -> dict:
    """The JAX package's ``init_cnn(key, cfg)``, draw for draw: conv
    weights ``normal / sqrt(9 c_in)``, dense weights truncated normals in
    (-2, 2) times ``1 / sqrt(d_in)``, zero biases, from ``split(key,
    n_conv + 2)``. Returns the trainer's params dict (dotted names) on
    ``device`` (None: the GPU). The draws are made on the host and equal
    the reference's bit for bit, so a run starts from its weights by the
    seed alone."""
    chans = cfg.cnn_channels or (32, 64)
    h, w, c_prev = cfg.input_hw
    keys = prng.split(key, len(chans) + 2)
    tree = {}
    for i, c in enumerate(chans):
        root = torch.sqrt(torch.tensor(9.0 * c_prev, dtype=torch.float64))
        tree[f"conv{i}"] = {
            "w": (prng.normal(keys[i], (3, 3, c_prev, c))
                  / root.to(torch.float32)).numpy(),
            "b": np.zeros(c, np.float32)}
        c_prev = c
        h, w = h // 2, w // 2
    dims = (h * w * c_prev, cfg.cnn_dense or 512, cfg.n_classes)
    for j, name in enumerate(("fc1", "fc2")):
        d_in, d_out = dims[j], dims[j + 1]
        wt = prng.truncated_normal(keys[len(chans) + j], -2.0, 2.0, (d_in, d_out))
        tree[name] = {"w": (wt * (1.0 / math.sqrt(d_in))).numpy(),
                      "b": np.zeros(d_out, np.float32)}
    return params_from_numpy(tree, device)


class CNN(nn.Module):
    def __init__(self, cfg, generator: torch.Generator | None = None):
        super().__init__()
        chans = cfg.cnn_channels or (32, 64)
        h, w, c_prev = cfg.input_hw
        self.n_conv = len(chans)
        for i, c in enumerate(chans):
            setattr(self, f"conv{i}", Conv3x3(c_prev, c))
            c_prev = c
            h, w = h // 2, w // 2
        dense = cfg.cnn_dense or 512
        self.fc1 = Dense(h * w * c_prev, dense)
        self.fc2 = Dense(dense, cfg.n_classes)
        for m in self.modules():
            if isinstance(m, (Conv3x3, Dense)):
                m.reset_parameters(generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: [B, H, W, C] float -> logits [B, n_classes]."""
        x = images.permute(0, 3, 1, 2)
        for i in range(self.n_conv):
            x = F.max_pool2d(F.relu(getattr(self, f"conv{i}")(x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)     # HWC order
        return self.fc2(F.relu(self.fc1(x)))


def cnn_loss(model: CNN):
    """``loss(params, batch) -> (loss, metrics)`` on a params dict (the
    functional form the batched client step differentiates)."""

    def loss(params: dict, batch: dict):
        logits = functional_call(model, params, (batch["images"],))
        labels = batch["labels"]
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, 1, labels[:, None])[:, 0]
        xent = torch.mean(nll)
        acc = torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
        return xent, {"xent": xent, "acc": acc}

    return loss
