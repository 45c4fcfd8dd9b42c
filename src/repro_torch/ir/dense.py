"""Dense (neural) first-stage retrieval (Q → R).

Counterpart of ``repro.ir.dense``.  Encode the corpus once, encode
queries online, take the top-k over the embedding matrix:

* the corpus matrix is one tensor resident on the encoder's device;
* ``backend="cuda"`` (the default) scores through ``dense_topk_op``:
  the hand-written kernel for CUDA tensors, its plain version for CPU
  tensors (the counterpart of the reference's ``"pallas"``);
  ``backend="torch"`` is the plain version on any device (the
  counterpart of ``"xla"``);
* ``DenseIndex.device_chunks`` splits the rows of a matrix on the card
  over the visible CUDA devices (the ``table_rows`` rule, as the
  reference splits over ``jax.devices()``), one ``(row_offset, chunk)``
  per device; ``topk`` merges the chunks' partial top-k on the host
  under the total order (score descending, then doc index ascending);
* that total order is what makes ``with_cutoff`` sound.

Embeddings come from the cross-encoder backbone in single-text mode
(masked mean pool, L2-normalised), in batches of 256 whose last is
padded with zero rows to a multiple of 8 as the reference pads it, each
through the process-wide ``CompileCache`` (one CUDA graph per batch
shape on the card); query embeddings are memoised per encoder (bounded
LRU), so hybrid systems encode each query once.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..caching import compile_cache
from ..core.frame import ColFrame
from ..core.pipeline import Transformer
from ..kernels.dense_topk import dense_topk_op, dense_topk_ref

# NOTE: cross_encoder is imported inside DenseEncoder.__init__ —
# cross_encoder imports repro_torch.ir.tokenizer, so a module-level
# import here would close an import cycle through repro_torch.ir.

__all__ = ["DenseEncoder", "DenseIndex", "DenseRetriever"]

_BACKENDS = {"cuda": dense_topk_op, "torch": dense_topk_ref}


class DenseEncoder:
    """Text -> embedding via the shared encoder backbone (mean pool)."""

    #: bound on the query-embedding memo (LRU, see ``encode_queries``)
    QUERY_MEMO_MAX = 4096

    def __init__(self, cfg, seed: int = 7, *, params: Optional[Dict] = None,
                 device: Union[str, torch.device, None] = None):
        from ..models.cross_encoder import Encoder
        from .tokenizer import HashTokenizer
        self.cfg = cfg
        self.seed = seed
        self.encoder = Encoder(cfg, seed, params=params, device=device)
        self.tokenizer = HashTokenizer(cfg.vocab_size)
        self._query_memo: "OrderedDict[str, torch.Tensor]" = OrderedDict()
        #: texts actually pushed through the backbone (memo hits do not
        #: count)
        self.encoded_texts = 0

    @property
    def device(self) -> torch.device:
        return self.encoder.device

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        pooled = self.encoder(tokens)
        return pooled / torch.clamp(
            torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), min=1e-6)

    def encode(self, texts: Sequence[str], batch: int = 256) -> torch.Tensor:
        """texts -> [len(texts), d_model] fp32 on the encoder's device."""
        outs = []
        with torch.inference_mode():
            for lo in range(0, len(texts), batch):
                chunk = texts[lo:lo + batch]
                toks = self.tokenizer.encode_batch(chunk, self.cfg.max_len)
                pad = (-len(chunk)) % 8
                if pad:
                    toks = np.concatenate([toks, np.zeros(
                        (pad, self.cfg.max_len), toks.dtype)])
                emb = compile_cache.default_compile_cache.call(
                    f"dense_encode:{self.cfg.name}", self._embed,
                    torch.from_numpy(toks).to(self.device),
                    weight_source=(self.cfg,) + self.encoder.weight_source)
                outs.append(emb[:len(chunk)])
                self.encoded_texts += len(chunk)
        if not outs:
            return torch.zeros((0, self.cfg.d_model), dtype=torch.float32,
                               device=self.device)
        return torch.cat(outs)

    @torch.inference_mode()
    def encode_queries(self, texts: Sequence[str]) -> torch.Tensor:
        """``encode`` behind a bounded per-encoder LRU memo: the weights
        are fixed for this instance, so each unique text is encoded
        once."""
        fresh: List[str] = []
        for t in texts:
            if t in self._query_memo:
                self._query_memo.move_to_end(t)
            elif t not in fresh:
                fresh.append(t)
        if fresh:
            for t, e in zip(fresh, self.encode(fresh)):
                self._query_memo[t] = e
            while len(self._query_memo) > self.QUERY_MEMO_MAX:
                self._query_memo.popitem(last=False)
        if not texts:
            return torch.zeros((0, self.cfg.d_model), dtype=torch.float32,
                               device=self.device)
        return torch.stack([self._query_memo[t] for t in texts])


def _devices(matrix: torch.Tensor) -> List[torch.device]:
    """The devices a corpus matrix is split over: every visible CUDA
    device for a matrix on the card, else the matrix's own device."""
    if matrix.device.type != "cuda":
        return [matrix.device]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class DenseIndex:
    """Corpus embedding matrix + docno map, its rows split over the
    local devices (``device_chunks``)."""

    def __init__(self, encoder: DenseEncoder):
        self.encoder = encoder
        self.docnos: list = []
        self.matrix: Optional[torch.Tensor] = None
        self._digest: Optional[str] = None
        # (the matrix they split, the chunks): rebuilt when it changes
        self._chunks: Optional[Tuple[torch.Tensor, list]] = None
        self.sharding_spec: Optional[tuple] = None

    def index(self, corpus_iter) -> "DenseIndex":
        rows = list(corpus_iter)
        self.docnos = [str(r["docno"]) for r in rows]
        self.matrix = self.encoder.encode([r["text"] for r in rows])
        self._digest = None
        return self

    def content_digest(self) -> str:
        """Stable digest of the docno map + embedding matrix bytes."""
        if self._digest is None:
            h = hashlib.sha256()
            h.update(repr(self.docnos).encode())
            if self.matrix is not None:
                h.update(self.matrix.cpu().numpy().tobytes())
            self._digest = h.hexdigest()[:16]
        return self._digest

    def device_chunks(self) -> List[Tuple[int, torch.Tensor]]:
        """Row-shard the corpus matrix across the local devices: the
        ``table_rows`` logical-axis rule of ``distrib/shardings.py``
        (rows over the data axis, feature dim replicated) on a 1-D
        mesh of ``_devices(matrix)``, as one contiguous
        ``(row_offset, resident chunk)`` per device.  The rule prunes
        the split when the rows do not divide, and then the matrix is
        one chunk, as in the reference."""
        if self.matrix is None:
            raise RuntimeError("index() before device_chunks()")
        if self._chunks is None or self._chunks[0] is not self.matrix:
            # deferred: distrib pulls in the model zoo, whose
            # cross-encoder imports back through repro_torch.ir
            from ..distrib.shardings import ShardingRules
            devs = _devices(self.matrix)
            mesh = SimpleNamespace(mesh_dim_names=("data",),
                                   shape=(len(devs),))
            self.sharding_spec = ShardingRules().spec_for(
                tuple(self.matrix.shape), ("table_rows", "table_dim"), mesh)
            n_rows = int(self.matrix.shape[0])
            n = len(devs) if (len(self.sharding_spec) and
                              self.sharding_spec[0] is not None) else 1
            n = max(1, min(n, n_rows))
            bounds = [(n_rows * i) // n for i in range(n + 1)]
            self._chunks = (self.matrix, [
                (lo, self.matrix[lo:hi].to(devs[i]))
                for i, (lo, hi) in enumerate(zip(bounds, bounds[1:]))
                if hi > lo])
        return self._chunks[1]

    def topk(self, q_emb: torch.Tensor, k: int, *,
             backend: str = "cuda") -> Tuple[np.ndarray, np.ndarray]:
        """Global top-k: a partial top-k per chunk, then a host merge
        under the total order (score desc, doc index asc)."""
        k = int(min(k, len(self.docnos)))
        fn = _BACKENDS[backend]
        parts_v, parts_i = [], []
        with torch.inference_mode():
            for lo, chunk in self.device_chunks():
                kk = min(k, int(chunk.shape[0]))
                v, i = fn(q_emb.to(chunk.device).contiguous(), chunk, k=kk)
                parts_v.append(v.cpu().numpy())
                parts_i.append(i.cpu().numpy().astype(np.int64) + lo)
        vals = np.concatenate(parts_v, axis=1)
        idxs = np.concatenate(parts_i, axis=1)
        out_v = np.empty((len(q_emb), k), np.float32)
        out_i = np.empty((len(q_emb), k), np.int64)
        for r in range(len(q_emb)):
            order = np.lexsort((idxs[r], -vals[r]))[:k]
            out_v[r] = vals[r][order]
            out_i[r] = idxs[r][order]
        return out_v, out_i

    def retriever(self, num_results: int = 100, *,
                  backend: str = "cuda") -> "DenseRetriever":
        return DenseRetriever(self, num_results=num_results,
                              backend=backend)


class DenseRetriever(Transformer):
    """Q → R over a DenseIndex via the fused matmul + top-k kernel."""

    input_columns = frozenset({"qid", "query"})
    output_columns = frozenset({"qid", "query", "docno", "score", "rank"})
    key_columns = ("qid", "query")
    one_to_many = True
    shardable = True                     # row-local per qid

    def __init__(self, index: DenseIndex, num_results: int = 100, *,
                 backend: str = "cuda"):
        if backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {sorted(_BACKENDS)}, "
                             f"got {backend!r}")
        self.index = index
        self.num_results = int(num_results)
        self.backend = backend

    def signature(self):
        return ("DenseRetriever", self.index.encoder.cfg.name,
                self.index.encoder.seed, len(self.index.docnos),
                self.num_results)

    def fingerprint_extras(self) -> Tuple:
        """Corpus content + scoring backend + encoder weight source:
        re-encoding the corpus, switching the kernel path (whose
        reductions may round differently) or changing the weights
        (native seed vs bridged arrays) must invalidate caches even
        though the structural ``signature()`` is unchanged."""
        return ("corpus", self.index.content_digest(),
                "backend", self.backend,
                "weights") + self.index.encoder.encoder.weight_source

    def with_cutoff(self, k: int) -> "DenseRetriever":
        """Absorb a downstream ``RankCutoff(k)`` into the retrieval
        depth.  Sound because ``DenseIndex.topk`` resolves score ties by
        ascending doc index — a total order, so the top-k of the
        top-``num_results`` equals the global top-k for ``k <=
        num_results``."""
        if int(k) >= self.num_results:
            return self                  # already at most k results
        return DenseRetriever(self.index, num_results=int(k),
                              backend=self.backend)

    def transform(self, inp: ColFrame) -> ColFrame:
        if len(inp) == 0 or self.index.matrix is None:
            return ColFrame()
        q_emb = self.index.encoder.encode_queries(
            [str(q) for q in inp["query"].tolist()])
        k = min(self.num_results, len(self.index.docnos))
        vals, idxs = self.index.topk(q_emb, k, backend=self.backend)
        rows = []
        for i, (qid, query) in enumerate(zip(inp["qid"].tolist(),
                                             inp["query"].tolist())):
            for r in range(k):
                rows.append({"qid": qid, "query": query,
                             "docno": self.index.docnos[int(idxs[i, r])],
                             "score": float(vals[i, r]), "rank": r})
        return ColFrame.from_dicts(rows)
