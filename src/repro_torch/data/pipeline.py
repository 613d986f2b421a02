"""Per-client batch pipelines.

* ``ClientDataset`` — one client's host-side shard (numpy), with the
  reference's cyclic/shuffled iterator for debugging;
* ``ClientData`` + ``sample_client_batches`` — all client shards padded to
  a common length and resident on the device as ``[N, L, ...]`` stacks,
  with batch selection a pure function of (key, round, client): the
  uniforms come from ``repro_torch.random`` exactly as the JAX package
  draws them, so both packages train on the same minibatches;
  ``sample_round_batches`` is a round's draw for every client.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import random as prng


class ClientDataset:
    """Holds one client's shard; yields minibatches cyclically."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, batch: int, seed: int):
        if len(images) != len(labels):
            raise ValueError(f"{len(images)} images but {len(labels)} labels")
        if len(labels) == 0:
            raise ValueError("ClientDataset shard is empty — drop the client "
                             "or re-draw the partition")
        self.images, self.labels = images, labels
        self.batch = batch
        self._rng = np.random.default_rng(seed)
        self._perm = self._rng.permutation(len(labels))
        self._cursor = 0

    def __len__(self):
        return len(self.labels)

    def next_batch(self) -> dict:
        parts, need = [], self.batch
        while need > 0:
            if self._cursor >= len(self._perm):
                self._perm = self._rng.permutation(len(self.labels))
                self._cursor = 0
            take = min(need, len(self._perm) - self._cursor)
            parts.append(self._perm[self._cursor:self._cursor + take])
            self._cursor += take
            need -= take
        idx = np.concatenate(parts) if len(parts) > 1 else parts[0]
        return {"images": self.images[idx], "labels": self.labels[idx]}


class ClientData(NamedTuple):
    """All client shards on the device: each array is [N, L_pad, ...] with
    the true shard sizes in ``lengths`` (padding rows are zeros and are
    never sampled). Ghost clients appended for a mesh
    (``pad_to_multiple``) have ``lengths == 0``: zero rows and zero
    aggregation weight."""
    arrays: dict              # field -> [N, L_pad, ...] tensor
    lengths: torch.Tensor     # [N] int32

    @property
    def n_clients(self) -> int:
        """Client-axis size, ghost clients included."""
        return int(self.lengths.shape[0])


def stack_client_datasets(datasets, device, *,
                          pad_to_multiple: int = 1) -> ClientData:
    """Pad + stack per-client shards onto ``device``.

    ``datasets`` is a list of ``ClientDataset`` (mapped to their
    images/labels fields) or of dicts of equal-keyed numpy arrays with the
    example axis leading. Floating fields become float32 and integer
    fields int64 (the index type PyTorch's gathers take).

    ``pad_to_multiple`` rounds the client axis up to a multiple (the size
    of a mesh's clients axis) by appending all-zero ghost clients with
    ``lengths == 0``; the real clients' rows are unchanged."""
    dicts = [{"images": d.images, "labels": d.labels}
             if isinstance(d, ClientDataset) else dict(d) for d in datasets]
    lengths = np.array([len(next(iter(d.values()))) for d in dicts], np.int32)
    if (lengths == 0).any():
        raise ValueError("empty client shard — drop the client or re-draw "
                         "the partition")
    if pad_to_multiple < 1:
        raise ValueError(f"pad_to_multiple must be >= 1, got {pad_to_multiple}")
    n = len(dicts)
    n_ghost = -(-n // pad_to_multiple) * pad_to_multiple - n
    L = int(lengths.max())
    arrays = {}
    for k in dicts[0]:
        parts = []
        for d, ln in zip(dicts, lengths):
            a = np.asarray(d[k])
            pad = [(0, L - int(ln))] + [(0, 0)] * (a.ndim - 1)
            parts.append(np.pad(a, pad))
        stacked = np.stack(parts)
        if n_ghost:
            ghosts = np.zeros((n_ghost,) + stacked.shape[1:], stacked.dtype)
            stacked = np.concatenate([stacked, ghosts])
        dtype = (torch.float32 if np.issubdtype(stacked.dtype, np.floating)
                 else torch.int64)
        arrays[k] = torch.as_tensor(stacked).to(device=device, dtype=dtype)
    lengths = np.concatenate([lengths, np.zeros(n_ghost, np.int32)])
    return ClientData(arrays=arrays,
                      lengths=torch.as_tensor(lengths).to(device))


def client_sample_keys(key: torch.Tensor, round_idx: int, n_real: int,
                       n_padded: int | None = None) -> torch.Tensor:
    """The ``[n_padded, 2]`` per-(round, client) batch keys.

    Real clients get ``split(fold_in(key, round), n_real)`` whatever the
    padding (``split``'s first keys change with its count, so ghosts must
    not enlarge it); ghost client i gets ``fold_in(rkey, i)``. A rank of a
    clients mesh computes the whole (tiny) set and slices its rows, so
    every layout draws the same batches."""
    rkey = prng.fold_in(key, round_idx)
    ks = prng.split(rkey, n_real)
    if n_padded is not None and n_padded > n_real:
        ghost = prng.fold_in(rkey, torch.arange(n_real, n_padded))
        ks = torch.cat([ks, ghost])
    return ks


def sample_client_batches(arrays: dict, lengths: torch.Tensor,
                          ckeys: torch.Tensor, local_steps: int,
                          batch: int) -> dict:
    """Draw [N, local_steps, batch, ...] minibatches from stacked shards.

    Indices follow the reference's fp32 rule
    ``min(int32(u * len), len - 1)`` with u uniform in [0, 1), drawn per
    client under its key (sampling with replacement)."""
    u = prng.uniform(ckeys, (local_steps, batch)).to(lengths.device)
    lf = lengths.to(torch.float32)[:, None, None]
    idx = (u * lf).to(torch.int32)
    idx = torch.minimum(idx, (lengths - 1)[:, None, None]).clamp(min=0).long()
    rows = torch.arange(lengths.shape[0], device=lengths.device)[:, None, None]
    return {k: v[rows, idx] for k, v in arrays.items()}


def sample_round_batches(data: ClientData, key: torch.Tensor, round_idx: int,
                         local_steps: int, batch: int,
                         n_real: int | None = None) -> dict:
    """A round's minibatches, field -> ``[N, local_steps, batch, ...]``:
    one key a client (``client_sample_keys``), indices drawn uniformly
    below the client's shard length (``sample_client_batches``). For a
    ghost-padded stack pass ``n_real`` (the true client count) so the real
    clients keep their unpadded key stream."""
    n = data.n_clients
    ckeys = client_sample_keys(key, round_idx, n_real or n, n)
    return sample_client_batches(data.arrays, data.lengths, ckeys,
                                 local_steps, batch)
