"""MoE training on the flash branch against the JAX package: the first
``build_train_step`` step of the smoke mixtral-8x22b in fp32 at S = 2048
(four MoE groups a row; head dim 32 under its 64-token window), with the
first gradients against ``jax.grad``; the reasons for one step are
``test_torch_train_moe_flash.py``'s.
"""
import pytest
import torch

from torch_train_families import run_both


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["mixtral-8x22b"])
def test_moe_flash_branch_step_matches_the_reference(arch):
    run_both(arch, 2048, 1, check_grads=True, steps_run=1, batch=1)
