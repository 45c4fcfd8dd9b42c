# Relation store, transformer algebra, measures and the Experiment
# abstraction (counterpart of repro.core without the plan compiler).
from .frame import ColFrame, Q, D, R, RA, relation_of
from .pipeline import (Transformer, Indexer, Compose, RankCutoff,
                       LinearCombine, ScalarProduct, FeatureUnion, SetUnion,
                       SetIntersection, Concatenate, Identity,
                       GenericTransformer, SourceResults, add_ranks,
                       stages_of, pipeline_hash)
from .measures import Measure, parse_measure, evaluate
from .experiment import Experiment, ExperimentResult

__all__ = [
    "ColFrame", "Q", "D", "R", "RA", "relation_of",
    "Transformer", "Indexer", "Compose", "RankCutoff", "LinearCombine",
    "ScalarProduct", "FeatureUnion", "SetUnion", "SetIntersection",
    "Concatenate", "Identity", "GenericTransformer", "SourceResults",
    "add_ranks", "stages_of", "pipeline_hash",
    "Measure", "parse_measure", "evaluate",
    "Experiment", "ExperimentResult",
]
