"""End-to-end example on the PyTorch port: train a neural reranker, then
evaluate it inside a cached pipeline against the BM25 baseline.

    PYTHONPATH=src python examples/train_reranker_torch.py [--steps 300]
        [--device cpu]

The counterpart of ``examples/train_reranker.py``: the same corpus
(``msmarco_like(1, scale=0.1)``), the same (query, doc, label) pairs from
the qrels and BM25-free random negatives, the same batches drawn from one
``np.random.default_rng(0)``, the same AdamW with ``linear_warmup_cosine``
through ``repro_torch.train.make_train_step``.  The Mono encoder is
trained as a tensor dict that requires grad (``encoder_score`` is plain
autograd; no kernel is on its path).  The trained weights go into a new
``MonoScorer(cfg, params=<numpy tree>)``: a new weight source, so new
``fingerprint_extras`` and a new CUDA-graph memo entry, and no cache
built for the untrained scorer serves it.  The config is the reference
example's, dimensioned down to the CPU.  Runs on CUDA unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.caching.provenance import set_digest_device
from repro_torch.core import Experiment
from repro_torch.device import resolve_device
from repro_torch.distrib.compression import CompressionConfig
from repro_torch.ir import InvertedIndex, TextLoader, msmarco_like
from repro_torch.models.common import _leaves, _unflatten, init_params
from repro_torch.models.cross_encoder import (EncoderConfig, MonoScorer,
                                              encoder_param_specs,
                                              encoder_score)
from repro_torch.train import (AdamWConfig, linear_warmup_cosine,
                               make_train_step)

#: the reference example's encoder, dimensioned down to the CPU
SMALL = EncoderConfig(n_layers=2, d_model=64, n_heads=4, d_ff=128,
                      vocab_size=8192, max_len=32)
BATCH = 64
OPT = AdamWConfig(lr=3e-3, weight_decay=0.01)
WARMUP = 20


class Setup:
    """The corpus, the BM25 index and the tokenised training pairs."""

    def __init__(self, cfg: EncoderConfig, device: torch.device):
        self.cfg, self.device = cfg, device
        self.dataset = msmarco_like(1, scale=0.1)
        self.index = InvertedIndex.build(self.dataset.get_corpus_iter())
        self.bm25 = self.index.bm25(num_results=50)
        self.loader = TextLoader(self.dataset.text_map())
        self.topics = self.dataset.get_topics()
        self.qrels = self.dataset.get_qrels()
        # (query, doc, label) pairs from the qrels, plus as many random
        # negatives, drawn exactly as the reference example draws them
        text = self.dataset.text_map()
        q_text = dict(zip(self.topics["qid"].tolist(),
                          self.topics["query"].tolist()))
        qids = self.qrels["qid"].tolist()
        pos = [(q_text[q], text[d]) for q, d in
               zip(qids, self.qrels["docno"].tolist())]
        self.rng = np.random.default_rng(0)
        docnos = self.dataset.docs["docno"].tolist()
        neg = [(q_text[q], text[docnos[self.rng.integers(len(docnos))]])
               for q in qids]
        pairs = pos + neg
        self.labels = np.array([1.0] * len(pos) + [0.0] * len(neg),
                               np.float32)
        tok = MonoScorer(cfg, device=device).tokenizer
        self.toks = np.stack([tok.encode_pair(q, t, cfg.max_len)
                              for q, t in pairs])

    def batch(self) -> Dict[str, torch.Tensor]:
        """The next batch of ``BATCH`` pairs (the reference's draw)."""
        idx = self.rng.integers(0, len(self.toks), BATCH)
        return {"toks": torch.from_numpy(self.toks[idx]).to(self.device),
                "y": torch.from_numpy(self.labels[idx]).to(self.device)}


def loss_fn(cfg: EncoderConfig) -> Callable:
    """Binary cross-entropy with logits of ``encoder_score``."""
    def loss(params: Dict, batch: Dict) -> torch.Tensor:
        z = encoder_score(params, batch["toks"], cfg).float()
        y = batch["y"]
        return torch.mean(torch.clamp(z, min=0) - z * y
                          + torch.log1p(torch.exp(-z.abs())))
    return loss


def train_step(loss: Callable, steps: int, *, microbatches: int = 1,
               compression: Optional[CompressionConfig] = None):
    """(step_fn, init_opt) of the example's optimiser and schedule over
    ``steps``, for ``loss(params, batch)``."""
    return make_train_step(
        loss, OPT,
        lr_schedule=lambda s: linear_warmup_cosine(s, warmup=WARMUP,
                                                   total=steps),
        microbatches=microbatches, compression=compression)


def train(setup: Setup, params: Dict, steps: int,
          log: Callable[[str], None] = print) -> Tuple[Dict, List[float]]:
    """``steps`` AdamW steps from ``params``; returns the trained tensor
    dict and every step's loss."""
    step_fn, init_opt = train_step(loss_fn(setup.cfg), steps)
    opt = init_opt(params)
    losses = []
    for step in range(steps):
        params, opt, m = step_fn(params, opt, setup.batch())
        losses.append(float(m["loss"]))
        if step % 50 == 0 or step == steps - 1:
            log(f"step {step:4d} loss {losses[-1]:.4f}")
    return params, losses


def to_numpy(params: Dict) -> Dict:
    """A tensor dict as the nested dict of numpy arrays the scorers take."""
    return _unflatten((path, t.detach().cpu().numpy())
                      for path, t in _leaves(params))


def evaluate(setup: Setup, trained: Dict):
    """(Experiment result, the trained scorer): BM25 against BM25 >> the
    trained Mono, with prefix precomputation."""
    scorer = MonoScorer(setup.cfg, params=to_numpy(trained),
                        device=setup.device)
    res = Experiment(
        [setup.bm25 % 10, setup.bm25 % 50 >> setup.loader >> scorer % 10],
        setup.topics, setup.qrels, ["nDCG@10", "MAP"],
        names=["bm25", "bm25 >> trained-mono"], baseline=0,
        precompute_prefix=True)
    return res, scorer


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cpu":
        set_digest_device("cpu")          # plan fingerprints on the CPU too
    t0 = time.perf_counter()
    setup = Setup(SMALL, device)
    params = init_params(encoder_param_specs(SMALL),
                         torch.Generator().manual_seed(0), device)
    params, _ = train(setup, params, args.steps)
    res, _ = evaluate(setup, params)
    print(res)
    print(f"wall {time.perf_counter() - t0:.1f} s on {device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
