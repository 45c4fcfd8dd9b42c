"""Generic train-step factory + host-side training loop (counterpart of
``repro.train.loop``).

``make_train_step(loss_fn, opt_cfg, ...)`` builds

    (params, opt_state, batch) -> (params, opt_state, metrics)

with optional microbatch gradient accumulation (a loop over equal
slices of the batch with fp32 accumulation: the reference's ``scan``)
and optional gradient compression with error feedback (its state under
``opt_state["ef"]``).

Gradients come from ``torch.autograd.grad(loss, leaves)`` over every
parameter, without ``allow_unused``: a parameter the loss does not reach
raises, where ``jax.grad`` would return zeros, so a gradient dropped on
the way (a kernel op autograd does not track) cannot pass unnoticed.
The kernel ops refuse autograd outright (``flash_attention_op``,
``embedding_bag_op``), so a loss through the LM takes
``attention="plain"``.

``train_loop`` has no ``jit=``: eager PyTorch has nothing to compile
there, and an unknown argument raises rather than being ignored.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..distrib.compression import CompressionConfig, compress_grads, \
    init_ef_state
from ..models.common import _leaves, _unflatten
from .optimizer import AdamWConfig, adamw_init, adamw_update
from .schedule import constant

__all__ = ["make_train_step", "train_loop"]


def _value_and_grad(loss_fn: Callable, params: Dict, batch: Any):
    """(loss, grads): grads a tree like ``params``, each in its dtype."""
    pairs = _leaves(params)
    leaves = [p.detach().requires_grad_(True) for _, p in pairs]
    with torch.enable_grad():
        loss = loss_fn(_unflatten((path, t) for (path, _), t
                                  in zip(pairs, leaves)), batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), _unflatten((path, g) for (path, _), g
                                     in zip(pairs, grads))


def _micro(batch: Any, i: int, n: int) -> Any:
    """The i-th of n equal slices of every leaf along dim 0."""
    if isinstance(batch, dict):
        return {k: _micro(v, i, n) for k, v in batch.items()}
    mb = batch.shape[0] // n
    return batch[i * mb:(i + 1) * mb]


def _step_grads(loss_fn: Callable, params: Dict, batch: Any,
                microbatches: int = 1):
    """(loss, grads) that a step takes: with microbatches, the mean of
    equal slices' losses and of their gradients, accumulated in fp32
    (the reference's ``scan``)."""
    if microbatches == 1:
        return _value_and_grad(loss_fn, params, batch)
    gsum = _unflatten((path, torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device))
                      for path, p in _leaves(params))
    losses = []
    for i in range(microbatches):
        loss, grads = _value_and_grad(loss_fn, params,
                                      _micro(batch, i, microbatches))
        for (_, a), (_, g) in zip(_leaves(gsum), _leaves(grads)):
            a.add_(g.float())
        losses.append(loss.float())
    return torch.stack(losses).mean(), _unflatten(
        (path, g / microbatches) for path, g in _leaves(gsum))


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig,
                    *, lr_schedule: Callable = constant,
                    microbatches: int = 1,
                    compression: Optional[CompressionConfig] = None):
    """loss_fn(params, batch) -> scalar loss.  Returns (train_step,
    init_opt).  The step updates the parameters and the optimizer state
    in place (``adamw_update``) and returns them."""
    compression = compression or CompressionConfig()
    use_ef = compression.method != "none"

    def train_step(params, opt_state, batch):
        loss, grads = _step_grads(loss_fn, params, batch, microbatches)
        if use_ef:
            grads, ef = compress_grads(grads, opt_state["ef"], compression)
        lr_scale = lr_schedule(opt_state["adam"]["step"])
        new_params, adam, om = adamw_update(params, grads,
                                            opt_state["adam"], opt_cfg,
                                            lr_scale)
        new_opt = {"adam": adam}
        if use_ef:
            new_opt["ef"] = ef
        metrics = {"loss": loss, "lr_scale": lr_scale, **om}
        return new_params, new_opt, metrics

    def init_opt(params):
        opt = {"adam": adamw_init(params, opt_cfg.moment_dtype)}
        if use_ef:
            opt["ef"] = init_ef_state(params)
        return opt

    return train_step, init_opt


def train_loop(params, batch_fn: Callable[[int], Any], loss_fn: Callable,
               *, n_steps: int, opt_cfg: Optional[AdamWConfig] = None,
               microbatches: int = 1,
               compression: Optional[CompressionConfig] = None,
               log_every: int = 10):
    """Single-host convenience loop (examples/tests). Returns
    (params, opt_state, history)."""
    opt_cfg = opt_cfg or AdamWConfig()
    step_fn, init_opt = make_train_step(
        loss_fn, opt_cfg, microbatches=microbatches, compression=compression)
    opt_state = init_opt(params)
    history = []
    for step in range(n_steps):
        batch = batch_fn(step)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % log_every == 0 or step == n_steps - 1:
            history.append({"step": step,
                            **{k: float(v) for k, v in metrics.items()}})
    return params, opt_state, history
