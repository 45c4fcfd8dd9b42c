# The paper's primary contribution: declarative IR pipelines (relation
# store + transformer algebra), prefix precomputation in experiments
# through the plan compiler, and the Experiment abstraction
# (counterpart of repro.core).
from .frame import ColFrame, Q, D, R, RA, relation_of
from .pipeline import (Transformer, Indexer, Compose, RankCutoff,
                       LinearCombine, ScalarProduct, FeatureUnion, SetUnion,
                       SetIntersection, Concatenate, Identity,
                       GenericTransformer, SourceResults, add_ranks,
                       stages_of, pipeline_hash)
from .precompute import (longest_common_prefix, split_on_prefix,
                         run_with_precompute, PrefixTrie, run_with_trie,
                         PrecomputeStats)
from .compile_opt import compile_pipeline
from .ir import IRNode, PlanGraph, lower, render_explain
from .rewrite import OPTIMIZER_PASSES, PassStats
from .cost import CostContext, CostModel
from .plan import ExecutionPlan, PlanNode, PlanStats, plan_size
from .measures import Measure, parse_measure, evaluate
from .experiment import Experiment, ExperimentResult

__all__ = [
    "ColFrame", "Q", "D", "R", "RA", "relation_of",
    "Transformer", "Indexer", "Compose", "RankCutoff", "LinearCombine",
    "ScalarProduct", "FeatureUnion", "SetUnion", "SetIntersection",
    "Concatenate", "Identity", "GenericTransformer", "SourceResults",
    "add_ranks", "stages_of", "pipeline_hash",
    "longest_common_prefix", "split_on_prefix", "run_with_precompute",
    "PrefixTrie", "run_with_trie", "PrecomputeStats",
    "ExecutionPlan", "PlanNode", "PlanStats", "plan_size",
    "IRNode", "PlanGraph", "lower", "render_explain",
    "OPTIMIZER_PASSES", "PassStats", "CostContext", "CostModel",
    "compile_pipeline", "Measure", "parse_measure", "evaluate",
    "Experiment", "ExperimentResult",
]
