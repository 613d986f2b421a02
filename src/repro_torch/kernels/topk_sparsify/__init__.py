from .ops import block_topk_rows, block_topk_sparsify, block_topk_sparsify_rows
from .ref import (block_topk_mask_ref, block_topk_ref, block_topk_rows_ref,
                  keep_count, topk_threshold_mask)

__all__ = ["block_topk_mask_ref", "block_topk_ref", "block_topk_rows",
           "block_topk_rows_ref", "block_topk_sparsify",
           "block_topk_sparsify_rows", "keep_count", "topk_threshold_mask"]
