"""MoE training on the flash branch against the JAX package: the first
``build_train_step`` step of the smoke qwen2-moe-a2.7b in fp32 at S =
2048 (four MoE groups a row; head dim 64), with the first gradients
against ``jax.grad`` (mixtral's, under its 64-token window at head dim 32:
``test_torch_train_mixtral_flash.py``).

One step, where ``test_torch_train_moe.py`` runs three at S = 512: at S =
2048 the first step's gradients and update agree (gradients within 4.3e-6
of scale), but by the third step the AdamW-amplified differences of the
first two move a token's routing past a near-tie and the parameters part
(8% of qwen2-moe's elements beyond 1e-5 of scale, loss rtol 2e-6):
discrete routing, not a fault. Gates in ``tests/torch_train_families.py``.
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


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b"])
def test_moe_flash_branch_step_matches_the_reference(arch):
    run_both(arch, 2048, 1, check_grads=True, steps_run=1, batch=1)
