from .kernel import dense_topk
from .ops import dense_topk_op
from .ref import dense_topk_ref

__all__ = ["dense_topk", "dense_topk_op", "dense_topk_ref"]
