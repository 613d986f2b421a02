"""fp16 NaNs in the top-k's plain version, wherever they fall (ROADMAP C-31).

``ref.topk_threshold_mask`` widens fp16 lanes to the fp32 patterns it
bisects on. Torch's CPU conversion keeps a NaN's payload with the quiet
bit set in its vector loop, but gives 0x7fffffff in its scalar tail (and
the card's conversion gives 0x7fffffff for every NaN); a block whose NaN
widens to 0x7fffffff takes the wrapped bisection and keeps other lanes.
The plain version now widens with integer operations (``ref.widen_f16``):
a NaN quiet with its payload kept, every other lane exact, as the
kernels and the reference's XLA:CPU convert do. Here the NaNs sit in the
last lanes of the vector, the conversion's scalar tail on one thread,
with the payloads of the fp16 cases the card's probe listed: the default
NaN 0x7e00, the all-ones 0x7fff, a signalling 0x7c01 and negative ones.
The result must equal the reference's interpreted Pallas kernel's bit for
bit, and the mask its threshold rule's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.topk_sparsify.ops import block_topk_sparsify as j_pallas
from repro.kernels.topk_sparsify.ref import topk_threshold_mask as j_mask
from repro_torch.kernels.topk_sparsify import ref

PAYLOADS = (0x7E00, 0x7FFF, 0x7C01, 0xFE00, 0xFFFF, 0x7D55)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the conversion's vector loop and scalar tail
    then fall where this file puts them (and the suite's workers share
    the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tail_nans(width: int, n_blocks: int, payload: int, seed: int) -> np.ndarray:
    """``n_blocks`` blocks of ``width`` fp16 lanes (normals) whose last 3
    lanes, and the last lane of every block, are NaNs of ``payload``."""
    rng = np.random.default_rng(seed)
    v = (rng.normal(size=width * n_blocks) * 0.1).astype(np.float16)
    bits = v.view(np.uint16)
    bits[-3:] = payload
    bits[width - 1::width] = payload
    return v


@pytest.mark.parametrize("payload", PAYLOADS, ids=hex)
@pytest.mark.parametrize("width", [17, 100, 8193])
@pytest.mark.parametrize("gamma", [0.1, 0.5])
def test_f16_nans_in_the_scalar_tail_keep_the_reference_mask(width, payload, gamma):
    x = _tail_nans(width, 3, payload, seed=width)
    got, k = ref.block_topk_ref(torch.from_numpy(x.view(np.int16)).view(torch.float16),
                                gamma, block=width)
    with jax.threefry_partitionable(False):
        want, k_ref = j_pallas(jnp.asarray(x), gamma, block=width)
        want_mask = j_mask(jnp.asarray(x).reshape(-1, width), k)
    assert k == k_ref
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    rows = torch.from_numpy(x.view(np.int16)).view(torch.float16).view(-1, width)
    np.testing.assert_array_equal(ref.topk_threshold_mask(rows, k).numpy(),
                                  np.asarray(want_mask))


@pytest.mark.parametrize("payload", PAYLOADS, ids=hex)
def test_widen_f16_quiets_nans_and_keeps_every_other_lane(payload):
    """Every fp16 pattern but the NaNs widens as torch's conversion does;
    a NaN becomes sign, 0x7fc00000 and its payload shifted by 13, at any
    position of a tensor."""
    bits = np.arange(1 << 16, dtype=np.uint16)
    h = torch.from_numpy(bits.view(np.int16)).view(torch.float16)
    wide = ref.widen_f16(h).view(torch.int32).numpy().view(np.uint32)
    nan = ((bits & 0x7C00) == 0x7C00) & ((bits & 0x3FF) != 0)
    plain = h.float().view(torch.int32).numpy().view(np.uint32)
    np.testing.assert_array_equal(wide[~nan], plain[~nan])
    b = bits[nan].astype(np.uint32)
    want = ((b & 0x8000) << 16) | 0x7FC00000 | ((b & 0x3FF) << 13)
    np.testing.assert_array_equal(wide[nan], want)
    one = torch.tensor([payload], dtype=torch.int32).to(torch.int16).view(torch.float16)
    p = np.uint32(payload)
    assert int(ref.widen_f16(one).view(torch.int32)) & 0xFFFFFFFF == int(
        ((p & 0x8000) << 16) | 0x7FC00000 | ((p & 0x3FF) << 13))
