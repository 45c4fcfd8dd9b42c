"""Architecture registry: ``--arch <id>`` resolution (counterpart of
``repro.configs.registry``)."""
from __future__ import annotations

from typing import Dict, List

from .base import ArchDef
from . import (granite_moe_3b_a800m, phi35_moe_42b_a66b, qwen3_14b,
               smollm_360m, qwen15_110b, gcn_cora, dlrm_rm2, mind, dcn_v2,
               two_tower_retrieval)

_MODULES = [granite_moe_3b_a800m, phi35_moe_42b_a66b, qwen3_14b,
            smollm_360m, qwen15_110b, gcn_cora, dlrm_rm2, mind, dcn_v2,
            two_tower_retrieval]

ARCHS: Dict[str, ArchDef] = {m.ARCH.name: m.ARCH for m in _MODULES}


def get_arch(name: str) -> ArchDef:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def all_cells() -> List[tuple]:
    """Every assigned (arch, shape) pair — the 40 dry-run cells."""
    return [(a.name, s) for a in ARCHS.values() for s in a.shape_names()]
