"""The encoders' weights, drawn by the benchmark from the seed.

One ``torch.Generator`` on the run's device draws every normal leaf in a
single call, in the configuration's dtype; the norms' scales are ones.
Matrices have standard deviation ``1/sqrt(fan_in)``, the embedding
tables 0.02.  The same tensors serve the reference; the port gets them
as the nested dict of numpy arrays its ``params=`` takes.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

__all__ = ["draw", "to_numpy"]


def _layout(cfg: Dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], float]]:
    """(path, shape, std) of every leaf; std 0 marks a scale of ones."""
    L, D, H = (cfg["num_hidden_layers"], cfg["hidden_size"],
               cfg["num_attention_heads"])
    F, V, S = (cfg["intermediate_size"], cfg["vocab_size"],
               cfg["max_position_embeddings"])
    hd = D // H
    return [
        (("embed",), (V, D), 0.02),
        (("pos",), (S, D), 0.02),
        (("layers", "ln1"), (L, D), 0.0),
        (("layers", "ln2"), (L, D), 0.0),
        (("layers", "wq"), (L, D, H, hd), D ** -0.5),
        (("layers", "wk"), (L, D, H, hd), D ** -0.5),
        (("layers", "wv"), (L, D, H, hd), D ** -0.5),
        (("layers", "wo"), (L, H, hd, D), D ** -0.5),
        (("layers", "w1"), (L, D, F), D ** -0.5),
        (("layers", "w2"), (L, F, D), F ** -0.5),
        (("ln_f",), (D,), 0.0),
        (("w_score",), (D, 1), D ** -0.5),
    ]


def draw(cfg: Dict, generator: torch.Generator) -> Dict:
    """Nested dict of tensors on the generator's device."""
    dt = getattr(torch, cfg["torch_dtype"])
    dev = generator.device
    layout = _layout(cfg)
    n = sum(int(np.prod(shape)) for _, shape, std in layout if std)
    flat = torch.randn(n, generator=generator, device=dev, dtype=dt)
    tree: Dict = {}
    at = 0
    for path, shape, std in layout:
        if std:
            size = int(np.prod(shape))
            leaf = flat[at:at + size].view(shape).mul_(std)
            at += size
        else:
            leaf = torch.ones(shape, device=dev, dtype=dt)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def to_numpy(tree: Dict) -> Dict:
    return {k: to_numpy(v) if isinstance(v, dict) else v.cpu().numpy()
            for k, v in tree.items()}
