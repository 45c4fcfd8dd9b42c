"""AdamW in plain PyTorch (counterpart of ``repro.train.optimizer``).

The optimizer state mirrors the parameter tree, as the reference's does:
``{"m": tree, "v": tree, "step": int32 0-d tensor}``, the moments in
``moment_dtype`` (fp32, or bf16 rounded to nearest even as ``.astype``
rounds), on the parameters' device.  Bias correction and the update are
in fp32, after global-norm clipping.

``adamw_update`` writes the new values into the given parameters and
moments, as ``torch.optim`` does, and returns them; the reference's
returns new arrays with the same values (same arithmetic, same order).
So a model with multi-GB tables (dlrm-rm2's are 8.65 GB) never holds two
copies of its weights and moments at once.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..models.common import ParamSpec, _leaves, _unflatten

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "adamw_state_specs"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    #: dtype of the m/v moments: fp32, or bf16 (half the state's memory)
    moment_dtype: torch.dtype = torch.float32


def _device(tree) -> torch.device:
    leaves = _leaves(tree)
    return leaves[0][1].device if leaves else torch.device("cpu")


def adamw_init(params, moment_dtype: torch.dtype = torch.float32) -> Dict:
    def zeros():
        return _unflatten((path, torch.zeros(p.shape, dtype=moment_dtype,
                                             device=p.device))
                          for path, p in _leaves(params))
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32,
                                device=_device(params))}


def adamw_state_specs(param_specs, moment_dtype: torch.dtype = torch.float32
                      ) -> Dict:
    """ParamSpec tree for the optimizer state (moments + step)."""
    def moments():
        return _unflatten((path, ParamSpec(s.shape, s.logical_axes,
                                           moment_dtype, init="zeros"))
                          for path, s in _leaves(param_specs))
    return {"m": moments(), "v": moments(),
            "step": ParamSpec((), (), torch.int32, init="zeros")}


def global_norm(tree) -> torch.Tensor:
    sq = sum(g.float().square().sum() for _, g in _leaves(tree))
    return torch.sqrt(sq)


def adamw_update(params, grads, state, cfg: AdamWConfig,
                 lr_scale=1.0) -> Tuple[Dict, Dict, Dict]:
    """One AdamW step with global-norm clipping, in place. Returns
    (params, state, metrics): the tensors given, updated, and a new
    step count."""
    with torch.no_grad():
        gnorm = global_norm(grads)
        limit = torch.tensor(cfg.grad_clip, dtype=torch.float32,
                             device=gnorm.device)
        clip = torch.clamp(limit / torch.clamp(gnorm, min=1e-12), max=1.0)
        step = state["step"] + 1
        t = step.float()
        bc1 = 1.0 - cfg.b1 ** t
        bc2 = 1.0 - cfg.b2 ** t
        lr = cfg.lr * lr_scale

        def upd(p, g, m, v):
            g = g.float() * clip
            m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
            v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
            mh = m32 / bc1
            vh = v32 / bc2
            delta = mh / (torch.sqrt(vh) + cfg.eps) \
                + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
            m.copy_(m32)
            v.copy_(v32)

        flat_g = dict(_leaves(grads))
        flat_m = dict(_leaves(state["m"]))
        flat_v = dict(_leaves(state["v"]))
        for path, p in _leaves(params):
            upd(p, flat_g[path], flat_m[path], flat_v[path])
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"grad_norm": gnorm}
