"""Device resolution for the port's entry points.

The port runs on the GPU unless the caller asks for the CPU.  There is
no silent fallback: asking for (or defaulting to) CUDA on a machine
without a CUDA device raises, so a run never reports CPU work as GPU
work.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``torch.device("cuda")`` by default; ``device`` when given.

    Raises ``RuntimeError`` when the resolved device is CUDA and no
    CUDA device is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev
