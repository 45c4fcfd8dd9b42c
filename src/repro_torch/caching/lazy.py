"""Lazy transformer construction (paper §4.5).

Counterpart of ``repro.caching.lazy``.

``Lazy(lambda: ExpensiveScorer())`` defers constructing a transformer
(e.g. loading a model onto the GPU) until it is actually invoked
— useful when a hot cache means it may never be needed.
"""
from __future__ import annotations

from typing import Callable, Optional

from ..core.frame import ColFrame
from ..core.pipeline import Transformer

__all__ = ["Lazy"]


class Lazy(Transformer):
    """Constructs the wrapped transformer at most once, on first use."""

    def __init__(self, factory: Callable[[], Transformer],
                 name: str = "lazy"):
        self.factory = factory
        self.name = name
        self._instance: Optional[Transformer] = None
        self.construction_count = 0

    def _resolve_lazy(self) -> Transformer:
        if self._instance is None:
            self._instance = self.factory()
            self.construction_count += 1
        return self._instance

    @property
    def constructed(self) -> bool:
        return self._instance is not None

    def transform(self, inp: ColFrame) -> ColFrame:
        return self._resolve_lazy()(inp)

    def signature(self):
        if self._instance is not None:
            return self._instance.signature()
        return ("Lazy", self.name)
