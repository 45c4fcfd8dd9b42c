#!/usr/bin/env python3
"""How far a random smollm-360m's bf16 logits lie from fp32, with the
reference's initialisation and with the attention projections rescaled
to the fan-in they contract (``chip_smoke.conditioned``).

Run from the root of a checkout:

    PYTHONPATH=src python3 tools/torch_lm_bf16_drift.py [--device cpu]
        [--layers 4 32] [--seq 256]

It runs on the card unless ``--device cpu`` is given, and raises when
there is no card.

For each depth and initialisation, one prefill's last-position logits
three ways: the kernel's entry point (``flash_attention_op``; its plain
version on the CPU) in bf16, the port's plain attention in bf16, and the
plain attention in fp32 from the same weights; prints the relative L2
distance of each pair.  The chunked plain attention runs from 128
tokens, as it does at the card's 4,096.
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
    ap.add_argument("--layers", type=int, nargs="+", default=[4, 32])
    ap.add_argument("--seq", type=int, default=256)
    args = ap.parse_args()
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.smollm_360m import CONFIG
    from repro_torch.device import resolve_device
    from repro_torch.models import lm

    device = resolve_device(args.device)

    torch.backends.cuda.matmul.allow_tf32 = False
    tokens = torch.randint(0, CONFIG.vocab_size, (1, args.seq),
                           generator=torch.Generator().manual_seed(1))
    tokens = tokens.to(device)
    rel = chip_smoke.rel_err
    for n_layers in args.layers:
        cfg = replace(CONFIG, n_layers=n_layers, chunked_attn_threshold=128,
                      attn_chunk=128)
        for init in ("reference", "conditioned"):
            params, _ = lm.load_params(cfg, seed=0, device=device)
            if init == "conditioned":
                chip_smoke.conditioned(params, cfg)
            p32 = {k: ({kk: vv.float() for kk, vv in v.items()}
                       if isinstance(v, dict) else v.float())
                   for k, v in params.items()}
            with torch.inference_mode():
                f32, _ = lm.prefill(p32, tokens,
                                    replace(cfg, dtype=torch.float32),
                                    attention="plain")
                flash, _ = lm.prefill(params, tokens, cfg)
                plain, _ = lm.prefill(params, tokens, cfg, attention="plain")
            print(json.dumps({
                "device": str(tokens.device), "layers": n_layers,
                "seq": args.seq, "init": init,
                "flash_vs_plain": rel(flash, plain),
                "flash_vs_fp32": rel(flash, f32),
                "plain_vs_fp32": rel(plain, f32),
                "max_abs_logit_fp32": float(f32.abs().max())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
