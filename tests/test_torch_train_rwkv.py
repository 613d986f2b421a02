"""RWKV6 training against the JAX package: ``build_train_step`` on the
smoke rwkv6-1.6b in fp32 at S = 512 (four 128-token chunks: the scan
carries its state across chunks), microbatches 1 and 2, remat on. Gates
in ``tests/torch_train_families.py``."""
import pytest
import torch

from torch_train_families import run_both


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_rwkv_train_steps_match_the_reference(microbatches):
    run_both("rwkv6-1.6b", 512, microbatches, check_grads=microbatches == 1)
