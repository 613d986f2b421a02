from .ops import l2_norm, row_l2_norms
from .ref import l2_norm_ref, row_l2_norms_ref

__all__ = ["l2_norm", "l2_norm_ref", "row_l2_norms", "row_l2_norms_ref"]
