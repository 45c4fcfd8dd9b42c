"""Deterministic, resumable, shardable data pipelines.

Counterpart of ``repro.data.pipeline``: pure numpy, so its batches are
byte-equal to the reference's (the port moves them to a device).

The fault-tolerance contract (distrib/fault.py) requires batches to be
a pure function of the step index — a restarted run must replay the
exact byte stream.  ``StepKeyedDataset`` packages that contract:

* ``batch(step)`` derives its RNG from ``SeedSequence([seed, step])`` —
  O(1) random access, no iterator state to checkpoint;
* ``shard(process_index, n_processes)`` gives each host its slice of
  the global batch (multi-host data loading posture) — slices of the
  same step compose to exactly the single-host batch;
* per-arch generators produce the right input trees for every assigned
  family (LM tokens, GCN graphs via the NeighborSampler, recsys
  dense/sparse rows).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import numpy as np

__all__ = ["StepKeyedDataset", "lm_synthetic", "recsys_synthetic",
           "gcn_sampled"]


def _rng(seed: int, step: int) -> np.random.Generator:
    # splitmix-style fold-in: independent stream per (seed, step)
    return np.random.default_rng(
        np.random.SeedSequence([seed, step]).generate_state(4))


@dataclass
class StepKeyedDataset:
    """batch = f(seed, step); optionally sharded across hosts."""

    generator: Callable[[np.random.Generator, int, int], Dict[str, Any]]
    global_batch: int
    seed: int = 0
    process_index: int = 0
    n_processes: int = 1

    def shard(self, process_index: int, n_processes: int
              ) -> "StepKeyedDataset":
        assert self.global_batch % n_processes == 0
        return StepKeyedDataset(self.generator, self.global_batch,
                                self.seed, process_index, n_processes)

    def batch(self, step: int) -> Dict[str, Any]:
        full = self.generator(_rng(self.seed, step), self.global_batch,
                              step)
        if self.n_processes == 1:
            return full
        per = self.global_batch // self.n_processes
        lo = self.process_index * per

        def slice_leaf(x):
            return x[lo:lo + per] if getattr(x, "shape", None) and \
                x.shape and x.shape[0] == self.global_batch else x

        return {k: slice_leaf(v) for k, v in full.items()}

    __call__ = batch


# -- per-family generators -----------------------------------------------------

def lm_synthetic(vocab_size: int, seq_len: int, *, pad_id: int = 0
                 ) -> Callable:
    def gen(rng: np.random.Generator, batch: int, step: int):
        toks = rng.integers(3, vocab_size, (batch, seq_len + 1),
                            dtype=np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return gen


def recsys_synthetic(cfg) -> Callable:
    """Matches the recsys models' batch schemas (planted CTR signal)."""
    def gen(rng: np.random.Generator, batch: int, step: int):
        if cfg.kind in ("dlrm", "dcn"):
            sparse = np.stack(
                [rng.integers(0, v, batch) for v in cfg.vocab_sizes],
                axis=1).astype(np.int32)
            dense = rng.normal(size=(batch, cfg.n_dense)).astype(np.float32)
            labels = ((sparse[:, 0] + sparse[:, 1]) % 2).astype(np.int32)
            return {"dense": dense, "sparse": sparse, "labels": labels}
        if cfg.kind == "mind":
            return {"hist_ids": rng.integers(
                        0, cfg.item_vocab, (batch, cfg.hist_len)
                    ).astype(np.int32),
                    "hist_mask": np.ones((batch, cfg.hist_len),
                                         np.float32),
                    "target_ids": rng.integers(
                        0, cfg.item_vocab, batch).astype(np.int32)}
        return {"user_ids": rng.integers(0, cfg.user_vocab,
                                         batch).astype(np.int32),
                "item_ids": rng.integers(0, cfg.item_vocab,
                                         batch).astype(np.int32)}
    return gen


def gcn_sampled(sampler, feats: np.ndarray, labels: np.ndarray,
                fanouts: Tuple[int, ...]) -> Callable:
    """Fixed-fanout sampled GCN batches via the real NeighborSampler."""
    n = feats.shape[0]

    def gen(rng: np.random.Generator, batch: int, step: int):
        seeds = rng.integers(0, n, batch).astype(np.int32)
        hops = sampler.sample(seeds, fanouts, seed=int(
            rng.integers(0, 2 ** 31 - 1)))
        f1, f2 = fanouts
        return {"feats_hop0": feats[hops["hop0"]],
                "feats_hop1": feats[hops["hop1"]],
                "feats_hop2": feats[hops["hop2"].reshape(batch, f1, f2)],
                "labels": labels[hops["hop0"]]}
    return gen
