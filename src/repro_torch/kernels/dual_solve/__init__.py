from .ops import dual_solve
from .ref import dual_solve_ref

__all__ = ["dual_solve", "dual_solve_ref"]
