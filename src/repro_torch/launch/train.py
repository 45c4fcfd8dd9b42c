"""End-to-end training driver (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 200 --preset tiny --ckpt-dir /tmp/ckpt [--device cpu]

Runs a real training loop on synthetic LM data with checkpoint/restart
supervision, on the card unless ``--device cpu``.  ``--preset tiny``
shrinks the arch (same family and flags, ``ArchDef.smoke``'s reduced
config) so a few hundred steps run on a CPU; ``--preset full`` uses the
published config.  The loss goes through the port's plain attention
(``causal_lm_loss(..., attention="plain")``): the attention kernel has
no backward pass.  Weights come from ``torch.Generator().manual_seed(0)``
on the host (``lm.load_params``), so a CPU and a card run start alike.

With ``--ckpt-dir`` the steps run under ``RestartableLoop`` with a
``Checkpointer``; a relaunch over a directory that holds checkpoints
resumes from the latest one, so its steps after it repeat the first
run's (the reference's loop starts at step 0 again).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

__all__ = ["synthetic_lm_batch", "init_weights", "main"]


def synthetic_lm_batch(cfg, batch: int, seq: int, step: int, device=None):
    """Step-keyed random tokens, the reference's: numpy
    ``default_rng(step)``, ids in [3, vocab)."""
    from ..device import resolve_device
    rng = np.random.default_rng(step)            # step-keyed (resumable)
    toks = torch.from_numpy(
        rng.integers(3, cfg.vocab_size, (batch, seq + 1), dtype=np.int32))
    dev = resolve_device(device)
    return {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}


def init_weights(cfg, device):
    """The run's initial weights: ``lm.load_params(cfg, seed=0)``."""
    from ..models import lm as LM
    return LM.load_params(cfg, seed=0, device=device)[0]


def main(argv=None):
    """Returns ((params, opt_state), the per-step metrics log: every
    step's metrics and ``dt``, its seconds)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--preset", choices=["tiny", "full"], default="tiny")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", choices=["none", "int8", "topk"],
                    default="none")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run here)")
    args = ap.parse_args(argv)

    from ..configs import get_arch
    from ..device import resolve_device
    from ..distrib import Checkpointer, CompressionConfig, RestartableLoop
    from ..models import lm as LM
    from ..train import AdamWConfig, linear_warmup_cosine, make_train_step

    dev = resolve_device(args.device)
    arch = get_arch(args.arch)
    if arch.family != "lm":
        raise SystemExit("train.py drives LM archs; see examples/ for "
                         "gnn/recsys training")
    cfg = arch.smoke()[0] if args.preset == "tiny" else arch.config

    params = init_weights(cfg, dev)

    def loss_fn(p, b):
        return LM.causal_lm_loss(p, b, cfg, attention="plain")

    step_fn, init_opt = make_train_step(
        loss_fn, AdamWConfig(lr=args.lr),
        lr_schedule=lambda s: linear_warmup_cosine(
            s, warmup=20, total=args.steps),
        microbatches=args.microbatches,
        compression=CompressionConfig(method=args.compress))

    def sfn(state, batch):
        p, o = state
        p, o, m = step_fn(p, o, batch)
        return (p, o), m

    def batch_fn(s):
        return synthetic_lm_batch(cfg, args.batch, args.seq, s, dev)

    state = (params, init_opt(params))

    if args.ckpt_dir:
        loop = RestartableLoop(sfn, batch_fn,
                               Checkpointer(args.ckpt_dir, keep=3,
                                            device=dev),
                               ckpt_every=args.ckpt_every)
        state = loop.run(state, args.steps, resume=True)
        log = loop.metrics_log
    else:
        log = []
        t0 = t = time.perf_counter()
        for s in range(args.steps):
            state, m = sfn(state, batch_fn(s))
            entry = {"step": s, **{k: float(v) for k, v in m.items()}}
            # reading the metrics waits for the step: dt is its wall
            now = time.perf_counter()
            entry["dt"], t = now - t, now
            log.append(entry)
            if s % 20 == 0 or s == args.steps - 1:
                print(entry)
        print(f"[{args.steps} steps in {time.perf_counter() - t0:.1f}s]")
    if log:
        first = next((e for e in log if "loss" in e), None)
        last = next((e for e in reversed(log) if "loss" in e), None)
        if first and last:
            print(f"loss {first['loss']:.3f} -> {last['loss']:.3f}")
    return state, log


if __name__ == "__main__":
    main()
