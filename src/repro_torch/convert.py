"""Weights from the JAX package's parameter trees.

``params_from_numpy(tree, device)`` turns a nested dict of numpy arrays
(``jax.device_get`` of a JAX package params tree) into the port's params
dict: dotted names in the JAX package's sorted leaf order, values copied
unchanged. It is the identity on values because the port keeps the
reference's layouts (HWIO convolutions, ``[in, out]`` dense weights; see
``models.module``). It is how tests give both packages the same weights.

``lm_params_from_numpy(tree, cfg, device)`` does the same for an LM
(``repro.models.transformer.init_lm``): each stacked leaf
``layers.<name>`` of shape ``[n_layers, ...]`` becomes the per-layer
parameters ``layers.<i>.<name>`` of ``models.transformer.LM``, values
unchanged; ``LM.load_state_dict`` takes the result.
"""
from __future__ import annotations

import numpy as np
import torch

from .devices import resolve_device
from .fl.updates import leaf_order


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def params_from_numpy(tree: dict, device=None) -> dict:
    """{"conv0": {"w": array, "b": array}, ...} -> {"conv0.b": tensor, ...}.
    ``device=None`` means the GPU, as at every entry point of the port."""
    device = resolve_device(device)
    flat = _flatten(tree)
    return {name: torch.tensor(np.asarray(flat[name]), device=device)
            for name in leaf_order(flat)}


def lm_params_from_numpy(tree: dict, cfg, device=None) -> dict:
    """{"embed": {"table": ...}, "layers": {"attn": {"wq": {"w": [L, d, hd*H]}},
    ...}, ...} -> {"embed.table": tensor, "layers.0.attn.wq.w": tensor, ...}.
    ``device=None`` means the GPU."""
    device = resolve_device(device)
    out = {}
    for name, value in _flatten(tree).items():
        arr = np.asarray(value)
        if name.startswith("layers."):
            if arr.shape[0] != cfg.n_layers:
                raise ValueError(f"{name} has {arr.shape[0]} layers, the config "
                                 f"{cfg.n_layers}")
            rest = name[len("layers."):]
            for i in range(cfg.n_layers):
                out[f"layers.{i}.{rest}"] = torch.tensor(arr[i], device=device)
        else:
            out[name] = torch.tensor(arr, device=device)
    return out
