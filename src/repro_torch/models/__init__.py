# Model zoo counterpart of repro.models: the shared machinery, the LM
# family (dense+MoE), the cross-encoders, GCN and recsys.
from . import common, lm, gcn, recsys, cross_encoder
from .common import (ParamSpec, init_params, abstract_params,
                     logical_axes_tree, count_params)

__all__ = ["common", "lm", "gcn", "recsys", "cross_encoder", "ParamSpec",
           "init_params", "abstract_params", "logical_axes_tree",
           "count_params"]
