from .kernel import cachekey_hash
from .ops import cachekey_hash_op, host_cachekey
from .ref import FNV_OFFSET, FNV_PRIME, LANE2_OFFSET, cachekey_hash_ref

__all__ = ["FNV_OFFSET", "FNV_PRIME", "LANE2_OFFSET", "cachekey_hash",
           "cachekey_hash_op", "cachekey_hash_ref", "host_cachekey"]
