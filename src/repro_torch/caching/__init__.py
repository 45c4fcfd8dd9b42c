# Counterpart of repro.caching; this slice ports the bucketed runner.
from .bucketing import BucketedRunner, bucket_size, pad_batch

__all__ = ["BucketedRunner", "bucket_size", "pad_batch"]
