"""MoE training against the JAX package: ``build_train_step`` on the smoke
qwen2-moe-a2.7b and mixtral-8x22b in fp32 (the aux loss through
``lm_loss``; fp32 routing equal to the reference's, C-22), remat on.

Three steps with microbatches 1 and 2 at S = 512: one MoE group of 512
tokens a row, the direct attention branch (the flash branch's first step
is ``test_torch_train_moe_flash.py``'s). Gates in
``tests/torch_train_families.py``."""
import pytest
import torch

from torch_train_families import run_both

ARCHS = ["qwen2-moe-a2.7b", "mixtral-8x22b"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_train_steps_match_the_reference(arch, microbatches):
    run_both(arch, 512, microbatches, check_grads=microbatches == 1)
