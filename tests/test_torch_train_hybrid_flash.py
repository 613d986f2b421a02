"""Mamba2-hybrid training on the flash branch against the JAX package:
the first ``build_train_step`` step of the smoke zamba2-2.7b in fp32 at S
= 2048, where its shared attention takes the flash branch (head dim 64,
where the reference's folded RoPE and the port's eager one agree: C-21),
with the first gradients against ``jax.grad``. Gates in
``tests/torch_train_families.py``."""
import pytest
import torch

from torch_train_families import run_both


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_hybrid_flash_branch_step_matches_the_reference():
    run_both("zamba2-2.7b", 2048, 1, check_grads=True, steps_run=1, batch=1)
