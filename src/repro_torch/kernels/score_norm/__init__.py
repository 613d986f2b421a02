from .ops import row_l2_norms
from .ref import row_l2_norms_ref

__all__ = ["row_l2_norms", "row_l2_norms_ref"]
