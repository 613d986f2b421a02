from .ops import dual_ascent, dual_solve
from .ref import dual_ascent_ref, dual_solve_ref

__all__ = ["dual_ascent", "dual_ascent_ref", "dual_solve", "dual_solve_ref"]
