"""The batched client step runs ``CLIENT_CHUNK`` clients a call whatever
the caller's count (ROADMAP C-17): a client's update, norm and loss must not
depend on how many clients share the step or where the client sits in it,
and the copies that pad the last chunk must not reach the results. Nor may
the aggregate depend on how the clients are split over ranks: the weighted
sum accumulates in float64. On the card this is what lets the sharded
trainer (a rank holds its share of the clients) equal one card;
``chip_smoke.client_step_by_card`` and ``--cards 4`` hold it there. Here
the same code runs on the CPU, with the smoke CNN, and is held bit for bit.
The port's step itself is held to the JAX package's in
``test_torch_stages.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.fmnist_cnn import SMOKE
from repro_torch.fl.client import CLIENT_CHUNK, make_batched_client_step
from repro_torch.fl.server import weighted_sum
from repro_torch.kernels.score_norm.ops import row_l2_norms
from repro_torch.models import CNN, cnn_loss


def _setup(n: int, seed: int = 0):
    model = CNN(SMOKE, torch.Generator().manual_seed(seed))
    params = {k: v.detach() for k, v in model.named_parameters()}
    rng = np.random.default_rng(seed)
    batches = {"images": torch.from_numpy(
                   rng.normal(size=(n, 2, 8, 28, 28, 1)).astype(np.float32)),
               "labels": torch.from_numpy(rng.integers(0, 10, size=(n, 2, 8)))}
    return make_batched_client_step(cnn_loss(model), 0.05), params, batches


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


C = CLIENT_CHUNK


@pytest.mark.parametrize("n,lo,hi", [
    (50, 13, 26),             # one of 4 cards' share, off the chunk boundary
    (8, 3, 4),                # 1 of 8
    (2 * C, C, 2 * C),        # the last whole chunk
    (C + 20, C - 3, C + 20),  # across a boundary into the last, partial chunk
    (C + 7, C + 2, C + 5),    # inside the last, partial chunk
])
def test_a_slice_of_clients_equals_their_rows_of_the_whole_step(n, lo, hi):
    step, params, batches = _setup(n)
    with torch.no_grad():
        whole = step(params, batches)
        part = step(params, {k: v[lo:hi] for k, v in batches.items()})
    for w, p in zip(whole, part):
        assert p.shape[0] == hi - lo
        assert _same(p, w[lo:hi])


def test_chunk_padding_never_reaches_the_results():
    """13 clients pad their chunk with 12 copies of the last one; the same
    13 clients beside 12 others fill a chunk with real clients. The 13 rows
    of updates, norms and losses are the same bits, and nothing else comes
    back; the step leaves cuDNN's flags as it found them."""
    assert CLIENT_CHUNK > 13
    step, params, batches = _setup(CLIENT_CHUNK, seed=1)
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    with torch.no_grad():
        full = step(params, batches)
        padded = step(params, {k: v[:13] for k, v in batches.items()})
    assert (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark) == flags
    updates, norms, losses = padded
    assert updates.shape == (13, full[0].shape[1])
    assert norms.shape == losses.shape == (13,)
    for got, want in zip(padded, full):
        assert _same(got, want[:13])
    assert _same(norms, row_l2_norms(updates))
    assert bool(torch.isfinite(updates).all())


@pytest.mark.parametrize("n,split", [(50, 13), (52, 13), (50, 7), (8, 3)])
def test_the_weighted_sum_does_not_depend_on_the_split(n, split):
    """The aggregate over all clients (one card) and the sum of the
    partial aggregates of each rank's share (a clients mesh, as its
    all-reduce adds them) round to the same float32 bits; both are the
    weighted sum in float64 to its rounding."""
    rng = np.random.default_rng(n + split)
    rows = (rng.normal(size=(n, 20_000))
            * 10.0 ** rng.uniform(-4, 0, (n, 1))).astype(np.float32)
    rows[rng.random(rows.shape) < 0.7] = 0.0          # sparsified rows
    w = (rng.random(n) / n).astype(np.float32)
    w[rng.random(n) < 0.5] = 0.0                      # unselected clients
    w_t, rows_t = torch.from_numpy(w), torch.from_numpy(rows)
    whole = weighted_sum(w_t, rows_t)
    assert whole.dtype == torch.float64
    parts = torch.zeros_like(whole)
    for i in range(0, n, split):
        parts += weighted_sum(w_t[i:i + split], rows_t[i:i + split])
    assert _same(whole.to(torch.float32), parts.to(torch.float32))
    exact = w.astype(np.float64) @ rows.astype(np.float64)
    np.testing.assert_allclose(whole.numpy(), exact, rtol=1e-12, atol=1e-18)
