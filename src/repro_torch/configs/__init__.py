"""Model configurations and the architecture registry (counterpart of
``repro.configs``): each config module's ``CONFIG`` and ``ARCH``, the
cell builders of the three families (``base``) and ``ARCHS``."""
from .registry import ARCHS, get_arch, all_cells
from .base import ArchDef, Cell, LM_SHAPES, GNN_SHAPES, RECSYS_SHAPES

__all__ = ["ARCHS", "get_arch", "all_cells", "ArchDef", "Cell",
           "LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES"]
