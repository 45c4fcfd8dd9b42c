from .kernel import bm25_block
from .ops import bm25_block_op
from .ref import bm25_block_ref

__all__ = ["bm25_block", "bm25_block_op", "bm25_block_ref"]
