"""LR schedules: pure functions of the step (counterpart of
``repro.train.schedule``).  Each returns a float32 0-d tensor, on the
step's device when the step is a tensor."""
from __future__ import annotations

import math

import torch

__all__ = ["linear_warmup_cosine", "constant"]


def constant(step, *, value: float = 1.0) -> torch.Tensor:
    device = step.device if isinstance(step, torch.Tensor) else None
    return torch.tensor(value, dtype=torch.float32, device=device)


def linear_warmup_cosine(step, *, warmup: int = 100, total: int = 10000,
                         floor: float = 0.1) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    progress = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * progress))
    return warm * (floor + (1.0 - floor) * cos)
