"""Serving launcher — thin wrapper over ``repro_torch.cli serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --pipeline hybrid \
        --scale 1.0

Counterpart of ``repro.launch.serve``, with the same flags and
``--device`` (CUDA unless ``cpu``).  Stands up a
:class:`~repro_torch.serve.PipelineService` over a registry pipeline
(default: the two-stage ``bm25-mono`` retrieve-and-rerank composition)
and drives it with a closed-loop synthetic request stream — the
request-level view of the paper's Table-2 mechanism, through the full
plan compiler.  All the real logic lives in the unified serving surface
(``repro_torch.serve.ServeConfig`` + ``drive_closed_loop``); this
module only keeps the legacy flag surface (``--requests`` /
``--max-batch`` / ``--no-cache``).
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=400)
    ap.add_argument("--pipeline", default="bm25-mono")
    ap.add_argument("--n-queries", type=int, default=20,
                    help="(legacy, ignored — the registry scenario "
                         "defines the topic pool)")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where the encoders and the dense index run "
                         "(default: cuda; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    from ..caching import set_digest_device
    from ..serve import ServeConfig, drive_closed_loop

    if args.device == "cpu":
        set_digest_device("cpu")         # plan fingerprints on the CPU too

    cfg = ServeConfig(
        pipeline=args.pipeline, scale=args.scale, cutoff=10,
        num_results=100, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, exec_workers=4, cache_dir=None,
        backend=None if args.no_cache else "memory", device=args.device)
    record = drive_closed_loop(cfg, requests=args.requests,
                               clients=args.clients)
    print({k: record[k] for k in ("requests", "batches", "hit_rate",
                                  "p50_ms", "p99_ms", "throughput_rps")})
    return record


if __name__ == "__main__":
    main()
