"""Weights from the JAX package's parameter trees.

``params_from_numpy(tree, device)`` turns a nested dict of numpy arrays
(``jax.device_get`` of a JAX package params tree) into the port's params
dict: dotted names in the JAX package's sorted leaf order, values copied
unchanged. It is the identity on values because the port keeps the
reference's layouts (HWIO convolutions, ``[in, out]`` dense weights; see
``models.module``). It is how tests give both packages the same weights.

``lm_params_from_numpy(tree, cfg, device)`` does the same for an LM
(``repro.models.transformer.init_lm``, the VLM's ``vision_proj`` among
its unstacked leaves): each stacked leaf ``layers.<name>`` of shape
``[n_layers, ...]`` becomes the per-layer parameters
``layers.<i>.<name>`` of ``models.transformer.LM``, values unchanged;
``LM.load_state_dict`` takes the result. ``encdec_params_from_numpy`` is
the same for the encoder-decoder (``repro.models.encdec.init_encdec``):
its stacks ``enc_layers`` (``n_encoder_layers``) and ``dec_layers``
(``n_layers``) onto ``models.encdec.EncDec``. ``lm_params_to_numpy`` and
``encdec_params_to_numpy`` are their inverses: the port's parameters
(name -> tensor) as the JAX package's nested tree of numpy arrays, each
per-layer leaf stacked back on a leading layer axis;
``model_params_from_numpy``/``model_params_to_numpy`` pick the family's
pair. ``adamw_state_to_numpy``/``adamw_state_from_numpy`` carry an AdamW
state (``optim.adamw``) of either the same two ways. So the train CLIs'
checkpoints (``repro_torch.checkpoint``, the JAX package's file layout)
restore in either package.
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


def _lm_stacks(cfg) -> dict:
    return {"layers": cfg.n_layers}


def _encdec_stacks(cfg) -> dict:
    return {"enc_layers": cfg.n_encoder_layers or cfg.n_layers,
            "dec_layers": cfg.n_layers}


def _unstack(tree: dict, stacks: dict, device) -> dict:
    """Each leaf under a stacked prefix (name -> layer count) split into
    its per-layer parameters ``<prefix>.<i>.<rest>`` on ``device``; the
    rest as they are."""
    out = {}
    for name, value in _flatten(tree).items():
        arr = np.asarray(value)
        prefix = name.split(".", 1)[0]
        if prefix in stacks and "." in name:
            n = stacks[prefix]
            if arr.shape[0] != n:
                raise ValueError(f"{name} has {arr.shape[0]} layers, the config {n}")
            rest = name[len(prefix) + 1:]
            for i in range(n):
                out[f"{prefix}.{i}.{rest}"] = torch.tensor(arr[i], device=device)
        else:
            out[name] = torch.tensor(arr, device=device)
    return out


def lm_params_from_numpy(tree: dict, cfg, device=None) -> dict:
    """{"embed": {"table": ...}, "layers": {"attn": {"wq": {"w": [L, d, hd*H]}},
    ...}, ...} -> {"embed.table": tensor, "layers.0.attn.wq.w": tensor, ...}.
    ``device=None`` means the GPU."""
    device = resolve_device(device)
    return _unstack(tree, _lm_stacks(cfg), device)


def encdec_params_from_numpy(tree: dict, cfg, device=None) -> dict:
    """{"enc_layers": {"attn": {"wq": {"w": [L_enc, d, hd*H]}}, ...},
    "dec_layers": {...}, "tok_embed": ..., "pos_embed": ...} ->
    {"enc_layers.0.attn.wq.w": tensor, ...}. ``device=None`` means the
    GPU."""
    device = resolve_device(device)
    return _unstack(tree, _encdec_stacks(cfg), device)


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


def _stack(params: dict, stacks: dict) -> dict:
    """The inverse of ``_unstack``: float32 numpy arrays, each per-layer
    leaf stacked back on a leading layer axis, nested."""
    flat, layers = {}, {}
    for name, t in params.items():
        arr = t.detach().to("cpu", torch.float32).numpy()
        prefix = name.split(".", 1)[0]
        if prefix in stacks:
            _, i, rest = name.split(".", 2)
            layers.setdefault((prefix, rest), [None] * stacks[prefix])[int(i)] = arr
        else:
            flat[name] = arr
    for (prefix, rest), arrs in layers.items():
        if any(a is None for a in arrs):
            raise ValueError(f"{prefix}.*.{rest} is missing for some of the "
                             f"{stacks[prefix]} layers")
        flat[f"{prefix}.{rest}"] = np.stack(arrs)
    return _nest(flat)


def lm_params_to_numpy(params: dict, cfg) -> dict:
    """{"embed.table": tensor, "layers.0.attn.wq.w": tensor, ...} ->
    {"embed": {"table": array}, "layers": {"attn": {"wq": {"w": [L, ...]}}},
    ...}: float32 numpy arrays, values unchanged."""
    return _stack(params, _lm_stacks(cfg))


def encdec_params_to_numpy(params: dict, cfg) -> dict:
    """The encoder-decoder's parameters as the JAX package's tree, the
    ``enc_layers`` and ``dec_layers`` leaves stacked."""
    return _stack(params, _encdec_stacks(cfg))


def model_params_from_numpy(tree: dict, cfg, device=None) -> dict:
    """``encdec_params_from_numpy`` for the audio family, else
    ``lm_params_from_numpy``."""
    if cfg.family == "audio":
        return encdec_params_from_numpy(tree, cfg, device)
    return lm_params_from_numpy(tree, cfg, device)


def model_params_to_numpy(params: dict, cfg) -> dict:
    """``encdec_params_to_numpy`` for the audio family, else
    ``lm_params_to_numpy``."""
    if cfg.family == "audio":
        return encdec_params_to_numpy(params, cfg)
    return lm_params_to_numpy(params, cfg)


def adamw_state_to_numpy(state: dict, cfg) -> dict:
    """A model's AdamW state as the JAX package's ``{"m", "v", "step"}``."""
    return {"m": model_params_to_numpy(state["m"], cfg),
            "v": model_params_to_numpy(state["v"], cfg),
            "step": np.asarray(int(state["step"]), np.int32)}


def adamw_state_from_numpy(tree: dict, cfg, device=None) -> dict:
    """The JAX package's AdamW state of an LM or an encoder-decoder as the
    port's (moments by parameter name). ``device=None`` means the GPU."""
    dev = resolve_device(device)
    return {"m": model_params_from_numpy(tree["m"], cfg, dev),
            "v": model_params_from_numpy(tree["v"], cfg, dev),
            "step": torch.tensor(int(np.asarray(tree["step"])),
                                 dtype=torch.int32, device=dev)}
