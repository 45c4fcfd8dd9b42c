"""Milliseconds of ExecutionPlan construction per Experiment (span)."""
from perfbench.metrics import readers


def read(m):
    return readers.plan_compile_ms(m)
