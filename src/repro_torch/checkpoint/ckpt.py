"""Flatten a tree of tensors to path-keyed numpy arrays in one ``.npz``.

The port's copy of ``repro.checkpoint.ckpt``, in the same file layout, so
that a checkpoint written by either package restores in the other:

* each leaf is stored under the key the reference derives from its
  ``jax.tree_util`` path: the path's entries joined by ``/``, a dict key
  as itself, a sequence index as its number, a ``NamedTuple`` field as
  ``.field``. ``leaf_paths`` derives the same strings without JAX: dicts
  flatten in sorted key order, ``NamedTuple``s field by field, lists and
  tuples by index; ``None`` and ``()`` hold no leaves;
* ``__meta__`` holds the caller's metadata as JSON, and ``__integrity__``
  a JSON record ``{key: [crc32, dtype, shape]}`` of every array.

``restore_checkpoint`` re-verifies each array against that record and
raises a descriptive ``CheckpointError`` on any mismatch — a bit-flipped
payload, a truncated file, a missing leaf, a dtype drift — instead of
resuming from corrupt state. ``latest_checkpoint`` skips (with a warning)
candidates that fail, so an interrupted final save falls back to the
previous good checkpoint. Checkpoints written before the integrity record
load permissively.
"""
from __future__ import annotations

import json
import os
import re
import warnings
import zipfile
import zlib

import numpy as np
import torch


class CheckpointError(RuntimeError):
    """A checkpoint failed to load or verify: corrupt or truncated file,
    checksum mismatch, missing array, or structure drift. The message
    names the file and the first offending entry."""


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaf_paths(tree, prefix: tuple = ()) -> list:
    """``[(path entries, leaf)]`` in ``jax.tree_util``'s flattening order.
    An entry is a dict key, a sequence index, or ``.field`` of a
    ``NamedTuple``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in leaf_paths(tree[k], prefix + (k,))]
    if _is_namedtuple(tree):
        return [pair for f in tree._fields
                for pair in leaf_paths(getattr(tree, f), prefix + (f".{f}",))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in leaf_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree) -> dict:
    return {_key(path): _numpy(leaf) for path, leaf in leaf_paths(tree)}


def _integrity_record(arrays: dict) -> dict:
    """{key: [crc32, dtype, shape]} over the saved payload bytes (CRC-32:
    a corruption tripwire, not a cryptographic seal)."""
    return {k: [zlib.crc32(np.ascontiguousarray(v).tobytes()),
                str(v.dtype), list(v.shape)]
            for k, v in arrays.items()}


def checkpoint_path(directory: str, step: int) -> str:
    """Where ``save_checkpoint`` writes step ``step``."""
    return os.path.join(directory, f"ckpt_{step:08d}.npz")


def save_checkpoint(directory: str, step: int, tree,
                    metadata: dict | None = None) -> str:
    """Write ``tree`` to ``directory/ckpt_{step:08d}.npz``; returns the
    path."""
    os.makedirs(directory, exist_ok=True)
    path = checkpoint_path(directory, step)
    arrays = _flatten_with_paths(tree)
    np.savez(path, __meta__=json.dumps(metadata or {}),
             __integrity__=json.dumps(_integrity_record(arrays)), **arrays)
    return path


def _load_npz(path: str) -> dict:
    """Every entry of the npz, loaded eagerly; the failure modes of a
    truncated or garbled file become CheckpointError."""
    try:
        with np.load(path, allow_pickle=False) as data:
            return {k: data[k] for k in data.files}
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, OSError, EOFError, KeyError,
            ValueError) as e:
        raise CheckpointError(
            f"checkpoint {path!r} is unreadable (truncated or corrupt "
            f"file): {type(e).__name__}: {e}") from e


def _verify(path: str, entries: dict) -> None:
    """Check every payload array against the ``__integrity__`` record.
    Checkpoints predating the record pass (nothing to verify)."""
    if "__integrity__" not in entries:
        return
    try:
        record = json.loads(str(entries["__integrity__"]))
    except (ValueError, TypeError) as e:
        raise CheckpointError(
            f"checkpoint {path!r}: integrity record is unparseable: {e}") from e
    payload = {k: v for k, v in entries.items()
               if k not in ("__meta__", "__integrity__")}
    missing = sorted(set(record) - set(payload))
    if missing:
        raise CheckpointError(
            f"checkpoint {path!r}: arrays {missing} are recorded in the "
            f"integrity manifest but absent from the file (partial write?)")
    extra = sorted(set(payload) - set(record))
    if extra:
        raise CheckpointError(
            f"checkpoint {path!r}: arrays {extra} are present but not in "
            f"the integrity manifest (mixed/garbled file?)")
    for key, (crc, dtype, shape) in record.items():
        arr = payload[key]
        if str(arr.dtype) != dtype or list(arr.shape) != list(shape):
            raise CheckpointError(
                f"checkpoint {path!r}: array {key!r} has dtype/shape "
                f"{arr.dtype}/{list(arr.shape)}, recorded "
                f"{dtype}/{shape}")
        if zlib.crc32(np.ascontiguousarray(arr).tobytes()) != crc:
            raise CheckpointError(
                f"checkpoint {path!r}: array {key!r} fails its CRC-32 "
                f"check — the file is corrupt (bit flip or partial "
                f"write); restore from an earlier checkpoint")


def verify_checkpoint(path: str) -> bool:
    """True iff ``path`` loads cleanly and passes its integrity record
    (vacuously true for checkpoints without one)."""
    try:
        _verify(path, _load_npz(path))
        return True
    except CheckpointError:
        return False


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*[_rebuild(getattr(tree, f), leaves)
                            for f in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def restore_checkpoint(path: str, like_tree):
    """Restore into the structure of ``like_tree`` (paths must match).
    Verifies the integrity record first; raises ``CheckpointError`` on
    corruption or on a leaf missing or shape-mismatched against
    ``like_tree``. Each leaf takes its like leaf's dtype: a tensor leaf
    comes back as a tensor on the like leaf's device, anything else as a
    numpy array."""
    entries = _load_npz(path)
    _verify(path, entries)
    arrays = {k: v for k, v in entries.items()
              if k not in ("__meta__", "__integrity__")}
    leaves = []
    for path_k, leaf in leaf_paths(like_tree):
        key = _key(path_k)
        if key not in arrays:
            raise CheckpointError(
                f"checkpoint {path!r} has no array for leaf {key!r}; "
                f"saved keys: {sorted(arrays)[:8]}...")
        arr = arrays[key]
        like = _numpy(leaf)
        if arr.shape != like.shape:
            raise CheckpointError(
                f"checkpoint {path!r}: leaf {key!r} has shape "
                f"{arr.shape}, expected {like.shape}")
        arr = arr.astype(like.dtype)
        if isinstance(leaf, torch.Tensor):
            arr = torch.as_tensor(np.array(arr)).to(leaf.device)
        leaves.append(arr)
    return _rebuild(like_tree, iter(leaves))


def load_metadata(path: str) -> dict:
    """The ``metadata`` dict a checkpoint was saved with ({} if none)."""
    entries = _load_npz(path)
    if "__meta__" not in entries:
        return {}
    try:
        return json.loads(str(entries["__meta__"]))
    except (ValueError, TypeError) as e:
        raise CheckpointError(
            f"checkpoint {path!r}: metadata is unparseable: {e}") from e


def latest_checkpoint(directory: str) -> str | None:
    """Newest checkpoint in ``directory`` that passes verification.
    Corrupt or truncated candidates are skipped with a warning (newest
    first); None when no valid candidate remains."""
    if not os.path.isdir(directory):
        return None
    cands = sorted(f for f in os.listdir(directory)
                   if re.match(r"ckpt_\d+\.npz", f))
    for name in reversed(cands):
        path = os.path.join(directory, name)
        if verify_checkpoint(path):
            return path
        warnings.warn(f"skipping corrupt checkpoint {path!r} "
                      f"(failed integrity verification)")
    return None
