#!/usr/bin/env python3
"""How far a random LM's bf16 logits lie from fp32, with the reference's
initialisation and with the attention projections rescaled to the
fan-in they contract (``chip_smoke.conditioned``).

Run from the root of a checkout:

    PYTHONPATH=src python3 tools/torch_lm_bf16_drift.py [--device cpu]
        [--arch smollm-360m] [--layers 4 32] [--seq 256] [--seed 0]
        [--keys 32768 --batch 4] [--inits reference conditioned]

It runs on the card unless ``--device cpu`` is given, and raises when
there is no card.  ``--arch`` is any LM of the registry, at its
published widths with ``--layers`` layers.  ``--seed`` draws the
weights (on the run's device), the tokens (from ``seed + 1``) and the
cache.

For each depth and initialisation, the logits of one run three ways: the
kernel's entry point (``flash_attention_op``; its plain version on the
CPU) in bf16, the port's plain attention in bf16, and the plain
attention in fp32 from the same weights; prints the relative L2 distance
of each pair.  The run is one prefill of ``--seq`` tokens (its last
position's logits; the chunked plain attention runs from 128 tokens, as
it does at the card's 4,096), or with ``--keys`` one decode step at the
last position of a cache of that many random keys at ``--batch`` (as
``chip_smoke.lm_step_at``).  An MoE's plain and fp32 runs take the
kernel run's expert picks (``chip_smoke.routing``), so the distances are
the numbers' alone; each line says how many picks each would have made
otherwise.
"""
from __future__ import annotations

import argparse
import json
import sys
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu runs the port on the CPU")
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--layers", type=int, nargs="+", default=[4, 32])
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keys", type=int, default=None,
                    help="one decode step into this many random keys")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--inits", nargs="+", default=["reference",
                                                   "conditioned"],
                    choices=["reference", "conditioned"])
    args = ap.parse_args()
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.models import lm
    from repro_torch.models.common import init_params

    device = resolve_device(args.device)
    config = get_arch(args.arch).config

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(args.seed + 1)
    if args.keys is None:
        tokens = torch.randint(0, config.vocab_size, (1, args.seq),
                               generator=gen).to(device)
    else:
        tokens = torch.randint(0, config.vocab_size, (args.batch,),
                               generator=gen).to(device)
    rel = chip_smoke.rel_err
    for n_layers in args.layers:
        cfg = replace(config, n_layers=n_layers, chunked_attn_threshold=128,
                      attn_chunk=128)
        cfg32 = replace(cfg, dtype=torch.float32)
        cache = cache32 = None
        if args.keys is not None:
            cache = lm.init_cache(cfg, args.batch, args.keys, device)
            g = torch.Generator(device=device).manual_seed(args.seed + 12)
            for t in cache.values():
                t.normal_(generator=g)
        for init in args.inits:
            params = init_params(lm.param_specs(cfg), torch.Generator(
                device=device).manual_seed(args.seed), device)
            if init == "conditioned":
                chip_smoke.conditioned(params, cfg)
            p32 = {k: ({kk: vv.float() for kk, vv in v.items()}
                       if isinstance(v, dict) else v.float())
                   for k, v in params.items()}

            def run(p, c, attention, cfg_=cfg):
                if args.keys is None:
                    return lm.prefill(p, tokens, cfg_,
                                      attention=attention)[0]
                return lm.decode_one(p, c, tokens, args.keys - 1, cfg_,
                                     attention=attention)[0]
            with torch.inference_mode():
                if cache is not None:
                    cache32 = {k: v.float() for k, v in cache.items()}
                with chip_smoke.routing(torch) as rec:
                    flash = run(params, cache, "flash")
                with chip_smoke.routing(torch, rec.seen) as pin:
                    plain = run(params, cache, "plain")
                with chip_smoke.routing(torch, rec.seen) as pin32:
                    f32 = run(p32, cache32, "plain", cfg32)
            del p32, cache32
            line = {"device": str(tokens.device), "arch": args.arch,
                    "layers": n_layers, "seed": args.seed, "init": init,
                    "flash_vs_plain": rel(flash, plain),
                    "flash_vs_fp32": rel(flash, f32),
                    "plain_vs_fp32": rel(plain, f32),
                    "max_abs_logit_fp32": float(f32.abs().max())}
            if args.keys is None:
                line["seq"] = args.seq
            else:
                line.update(keys=args.keys, batch=args.batch)
            if rec.seen:
                line.update(picks=sum(t.numel() for t in rec.seen),
                            plain_flips=pin.flips, fp32_flips=pin32.flips)
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
