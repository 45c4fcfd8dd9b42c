# Hand-written Hopper kernels, one package each (csrc/<name>.cu, kernel.py
# launch wrapper, ops.py dispatch, ref.py plain version), built by _build
# at a kernel's first launch, never at import.
from . import (flash_attention, embedding_bag, cachekey_hash, bm25_block,
               dense_topk)

__all__ = ["flash_attention", "embedding_bag", "cachekey_hash",
           "bm25_block", "dense_topk"]
