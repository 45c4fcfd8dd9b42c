# Step-keyed data pipelines (counterpart of repro.data).
from .pipeline import (StepKeyedDataset, lm_synthetic, recsys_synthetic,
                       gcn_sampled)

__all__ = ["StepKeyedDataset", "lm_synthetic", "recsys_synthetic",
           "gcn_sampled"]
