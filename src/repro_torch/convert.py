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
``lm_params_to_numpy(params, cfg)`` is its inverse: the port's LM
parameters (name -> tensor) as the JAX package's nested tree of numpy
arrays, each per-layer leaf stacked back on a leading ``[n_layers]`` axis.
``adamw_state_to_numpy``/``adamw_state_from_numpy`` carry an AdamW state
(``optim.adamw``) the same two ways. So the train CLIs' checkpoints
(``repro_torch.checkpoint``, the JAX package's file layout) restore in
either package.
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


def _nest(flat: dict) -> dict:
    """{"a.b": x} -> {"a": {"b": x}}."""
    out: dict = {}
    for name, value in flat.items():
        node = out
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = value
    return out


def lm_params_to_numpy(params: dict, cfg) -> dict:
    """{"embed.table": tensor, "layers.0.attn.wq.w": tensor, ...} ->
    {"embed": {"table": array}, "layers": {"attn": {"wq": {"w": [L, ...]}}},
    ...}: float32 numpy arrays, values unchanged."""
    flat, layers = {}, {}
    for name, t in params.items():
        arr = t.detach().to("cpu", torch.float32).numpy()
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            layers.setdefault(rest, [None] * cfg.n_layers)[int(i)] = arr
        else:
            flat[name] = arr
    for rest, arrs in layers.items():
        if any(a is None for a in arrs):
            raise ValueError(f"layers.*.{rest} is missing for some of the "
                             f"{cfg.n_layers} layers")
        flat[f"layers.{rest}"] = np.stack(arrs)
    return _nest(flat)


def adamw_state_to_numpy(state: dict, cfg) -> dict:
    """An LM's AdamW state as the JAX package's ``{"m", "v", "step"}``."""
    return {"m": lm_params_to_numpy(state["m"], cfg),
            "v": lm_params_to_numpy(state["v"], cfg),
            "step": np.asarray(int(state["step"]), np.int32)}


def adamw_state_from_numpy(tree: dict, cfg, device=None) -> dict:
    """The JAX package's AdamW state of an LM as the port's (moments by
    parameter name). ``device=None`` means the GPU."""
    dev = resolve_device(device)
    return {"m": lm_params_from_numpy(tree["m"], cfg, dev),
            "v": lm_params_from_numpy(tree["v"], cfg, dev),
            "step": torch.tensor(int(np.asarray(tree["step"])),
                                 dtype=torch.int32, device=dev)}
