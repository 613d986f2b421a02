from .ops import block_topk_rows
from .ref import block_topk_rows_ref, topk_threshold_mask

__all__ = ["block_topk_rows", "block_topk_rows_ref", "topk_threshold_mask"]
