"""Fault tolerance: restart driver + straggler mitigation policy.

Counterpart of ``repro.distrib.fault``, with the same semantics.

``RestartableLoop`` is the generic supervisor a cluster scheduler would
run per slice: execute the step function, checkpoint every
``ckpt_every`` steps, and on *any* failure restore the last committed
checkpoint and resume.  Determinism contract: the data pipeline is
step-keyed (``batch_fn(step)``), so a restarted run replays the exact
byte stream — tests assert bit-equal final params between an
uninterrupted run and a run with injected preemptions.

``StragglerPolicy`` is the deadline-barrier policy used at scale:
per-step durations feed an EWMA; a step exceeding
``deadline_factor × ewma`` is flagged, and after ``evict_after``
consecutive flags the (simulated) worker is marked for eviction —
which in a real deployment triggers an elastic restart on the reduced
mesh (the checkpoint layer's device-agnostic manifest is what makes that
restart possible).

``RetryPolicy`` is the shared retry/backoff envelope: a bounded
attempt count with exponentially growing (capped) delays.  The serve
fleet (``serve/fleet.py``) uses it both to pace worker respawns and to
bound how often an accepted request may be requeued onto survivors.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .checkpoint import Checkpointer

__all__ = ["RestartableLoop", "RetryPolicy", "StragglerPolicy",
           "Preemption"]


class Preemption(RuntimeError):
    """Simulated node failure."""


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with capped exponential backoff.

    ``max_retries`` counts *retries*, not attempts: a policy with
    ``max_retries=3`` allows 4 total attempts.  ``delay(attempt)`` is
    the pause before retry number ``attempt`` (1-based), growing as
    ``base_delay_s * multiplier**(attempt-1)`` up to ``max_delay_s``.
    """

    max_retries: int = 3
    base_delay_s: float = 0.05
    multiplier: float = 2.0
    max_delay_s: float = 2.0

    def delay(self, attempt: int) -> float:
        if attempt <= 0:
            return 0.0
        d = self.base_delay_s * self.multiplier ** (attempt - 1)
        return min(d, self.max_delay_s)

    def allows(self, attempt: int) -> bool:
        """Whether retry number ``attempt`` (1-based) is still within
        budget."""
        return attempt <= self.max_retries

    def call(self, fn: Callable[[], Any], *,
             retry_on: Tuple[type, ...] = (Exception,),
             sleep: Callable[[float], None] = time.sleep) -> Any:
        """Run ``fn`` under this policy: on a ``retry_on`` exception,
        back off and retry; re-raise once the budget is exhausted."""
        attempt = 0
        while True:
            try:
                return fn()
            except retry_on:
                attempt += 1
                if not self.allows(attempt):
                    raise
                sleep(self.delay(attempt))


@dataclass
class StragglerPolicy:
    deadline_factor: float = 3.0
    evict_after: int = 3
    ewma_alpha: float = 0.2
    _ewma: Optional[float] = None
    flags: int = 0
    flagged_steps: List[int] = field(default_factory=list)
    evicted: bool = False

    def observe(self, step: int, duration_s: float) -> str:
        """Returns 'ok' | 'straggle' | 'evict'."""
        if self._ewma is None:
            self._ewma = duration_s
            return "ok"
        verdict = "ok"
        if duration_s > self.deadline_factor * self._ewma:
            self.flags += 1
            self.flagged_steps.append(step)
            verdict = "straggle"
            if self.flags >= self.evict_after:
                self.evicted = True
                verdict = "evict"
        else:
            self.flags = 0
            # only healthy steps update the baseline
            self._ewma = (1 - self.ewma_alpha) * self._ewma \
                + self.ewma_alpha * duration_s
        return verdict


class RestartableLoop:
    """Checkpoint/restart supervisor around a step function.

    ``step_fn`` returns a new state and leaves its input as it was, as a
    JAX step does.  A preemption before the first checkpoint restarts
    from the state ``run`` was given, at step 0; the reference restarts
    at step 0 from the state the lost steps left, so its result differs
    from an uninterrupted run there."""

    def __init__(self, step_fn: Callable, batch_fn: Callable[[int], Any],
                 ckpt: Checkpointer, *, ckpt_every: int = 10,
                 max_restarts: int = 10,
                 straggler: Optional[StragglerPolicy] = None):
        self.step_fn = step_fn            # (state, batch) -> state, metrics
        self.batch_fn = batch_fn          # step -> batch (deterministic!)
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.straggler = straggler or StragglerPolicy()
        self.restarts = 0
        self.metrics_log: List[Dict] = []

    def run(self, state: Any, n_steps: int,
            fail_at: Optional[Dict[int, int]] = None,
            resume: bool = False) -> Any:
        """Run to n_steps; ``fail_at`` maps step->restart_ordinal for
        injected preemptions (test hook).  With ``resume``, start from
        the latest checkpoint when there is one (a relaunched job
        continues where its checkpoints end; the reference always starts
        at step 0)."""
        fail_at = fail_at or {}
        initial, step = state, 0
        if resume and self.ckpt.latest() is not None:
            state, step = self.ckpt.restore(state)
        while step < n_steps:
            try:
                while step < n_steps:
                    if step in fail_at and fail_at[step] == self.restarts:
                        raise Preemption(f"injected failure at step {step}")
                    t0 = time.perf_counter()
                    batch = self.batch_fn(step)
                    state, metrics = self.step_fn(state, batch)
                    dt = time.perf_counter() - t0
                    verdict = self.straggler.observe(step, dt)
                    self.metrics_log.append(
                        {"step": step, "dt": dt, "verdict": verdict,
                         **{k: float(v) for k, v in (metrics or {}).items()}})
                    step += 1
                    if step % self.ckpt_every == 0 or step == n_steps:
                        self.ckpt.wait()
                        self.ckpt.save(step, state)
            except Preemption:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                last = self.ckpt.latest()
                if last is None:
                    state, step = initial, 0    # restart from scratch
                    continue
                state, step = self.ckpt.restore(state)
        return state
