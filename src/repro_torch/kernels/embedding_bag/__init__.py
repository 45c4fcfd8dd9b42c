from .kernel import embedding_bag
from .ops import embedding_bag_op
from .ref import embedding_bag_ref

__all__ = ["embedding_bag", "embedding_bag_op", "embedding_bag_ref"]
