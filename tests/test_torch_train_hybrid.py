"""Mamba2-hybrid training against the JAX package: ``build_train_step`` on
the smoke zamba2-2.7b in fp32, remat on (each Mamba layer checkpointed,
the shared block once a group): three steps with microbatches 1 and 2
at S = 1024 (the direct attention branch; eight 128-token chunks a Mamba
layer). The first gradients are held against ``jax.grad`` at S = 2048
(``test_torch_train_hybrid_flash.py``, within 5.5e-6 of every leaf's
scale): at S = 1024 the Mamba2 decay leaves' gradients (``A_log``,
``dt_bias``), sums over every position and head whose terms cancel, lie
2.2e-5 and 1.8e-5 of their scale apart (the rest within 4.1e-6). Gates in
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


@pytest.mark.parametrize("microbatches", [1, 2])
def test_hybrid_train_steps_match_the_reference(microbatches):
    run_both("zamba2-2.7b", 1024, microbatches, check_grads=False)
