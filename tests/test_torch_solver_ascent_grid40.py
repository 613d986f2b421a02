"""The fused dual ascent's plain version against the JAX package's
``solve_round`` on the 40-level joint grid (the paper's 10 gammas x 4
widths) that the kernels take since their level table became a device
buffer: split from ``test_torch_solver_ascent.py`` so that ``--dist
loadfile`` gives it a worker of its own.
"""
import pytest

from torch_solver_rounds import BITS40, hold_rounds


@pytest.mark.parametrize("variant", ["joint", "joint_scaled"])
@pytest.mark.parametrize("case", ["capped", "dead_clients"])
def test_dual_ascent_ref_matches_reference_solver_at_40_levels(variant, case):
    """The same four rounds on the 40-level joint grid (10 gammas x
    ``BITS40``), past the 32 levels of one lane group."""
    hold_rounds(variant, case, BITS40)
