"""GCN (Kipf & Welling, arXiv:1609.02907) with all four shape regimes, in
PyTorch.

Counterpart of ``repro.models.gcn``.  Message passing is a scatter-add
over an edge-index -> node map: the reference's ``jax.ops.segment_sum``
is ``index_add`` here.  On the card that sum is atomic, so its order,
and the last bits of a node's sum, change from run to run: checks on
the card use a tolerance.

* ``full_graph`` — symmetric-normalized Ã·X·W over the whole graph;
* ``minibatch`` — GraphSAGE-style fixed-fanout neighbor sampling (the
  numpy ``NeighborSampler``, byte-equal to the reference's) + per-hop
  dense gathers;
* ``molecule`` — batched small graphs, flattened with node offsets.

Nodes/edges are padded to mesh-friendly multiples; padding rows carry
zero features and a degree of 1 so they are numerically inert.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .common import (ParamSpec, gather_rows, is_split, load_weights, plain,
                     replicate_like, scatter_add_rows)

__all__ = ["GCNConfig", "gcn_param_specs", "gcn_full_graph_logits",
           "gcn_full_graph_loss", "gcn_sampled_loss", "gcn_molecule_loss",
           "NeighborSampler", "pad_graph", "load_params"]


@dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn-cora"
    n_layers: int = 2
    d_feat: int = 1433
    d_hidden: int = 16
    n_classes: int = 7
    aggregator: str = "mean"     # mean (sym-normalized)
    dtype: torch.dtype = torch.float32
    # minibatch regime
    fanouts: Tuple[int, ...] = (15, 10)


def gcn_param_specs(cfg: GCNConfig) -> Dict:
    dims = [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    layers = {}
    for i in range(cfg.n_layers):
        layers[f"w{i}"] = ParamSpec((dims[i], dims[i + 1]),
                                    ("gnn_in", "gnn_out"), cfg.dtype,
                                    init="he")
        layers[f"b{i}"] = ParamSpec((dims[i + 1],), ("gnn_out",), cfg.dtype,
                                    init="zeros")
    return layers


def load_params(cfg: GCNConfig, seed: int = 0, *,
                params: Optional[Dict] = None,
                device: Union[str, torch.device, None] = None
                ) -> Tuple[Dict, Tuple]:
    """(weights on the device, their source), as ``lm.load_params``:
    bridged from a nested dict of numpy arrays, or drawn from
    ``torch.Generator().manual_seed(seed)``."""
    return load_weights(gcn_param_specs(cfg), seed, params=params,
                        device=device)


def pad_graph(n: int, multiple: int = 512) -> int:
    return ((n + multiple - 1) // multiple) * multiple


# ---------------------------------------------------------------------------
# full-graph regime
# ---------------------------------------------------------------------------

def _sym_norm_agg(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                  deg: torch.Tensor) -> torch.Tensor:
    """Ã X with Ã = D^-1/2 (A+I) D^-1/2; edges (src→dst) + self loops.

    x [N,F]; src/dst [E] int; deg [N] (including self loop).
    """
    inv_sqrt = torch.rsqrt(torch.clamp(deg.float(), min=1.0))
    src, dst = src.long(), dst.long()
    msg = gather_rows(x, src) * (gather_rows(inv_sqrt, src)
                                 * gather_rows(inv_sqrt, dst)
                                 )[:, None].to(x.dtype)
    agg = scatter_add_rows(x, dst, msg)
    return agg + x * (inv_sqrt * inv_sqrt)[:, None].to(x.dtype)  # self loop


def gcn_full_graph_logits(params: Dict, feats: torch.Tensor,
                          src: torch.Tensor, dst: torch.Tensor,
                          deg: torch.Tensor, cfg: GCNConfig) -> torch.Tensor:
    x = feats
    for i in range(cfg.n_layers):
        # GCN canonical order: X W, then Ã (X W)
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        x = _sym_norm_agg(x, src, dst, deg)
        if i < cfg.n_layers - 1:
            x = F.relu(x)
    return x


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    if is_split(logits, labels):
        # DTensor's gather of rows split over two mesh axes leaves a
        # masked partial sum it cannot reduce: pick the gold logit by a
        # one-hot sum instead
        classes = replicate_like(torch.arange(logits.shape[-1],
                                              device=logits.device), logits)
        return torch.logsumexp(logits, dim=-1) - torch.where(
            classes == labels.long()[:, None], logits, 0.0).sum(dim=-1)
    return plain(_nll_of, logits, labels)


def _nll_of(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, labels.long()[:, None])[:, 0]
    return logz - gold


def gcn_full_graph_loss(params: Dict, batch: Dict, cfg: GCNConfig):
    logits = gcn_full_graph_logits(params, batch["feats"], batch["src"],
                                   batch["dst"], batch["deg"], cfg)
    labels, mask = batch["labels"], batch["label_mask"]
    nll = _nll(logits, torch.clamp(labels, min=0)) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# sampled-minibatch regime (GraphSAGE-style fanout sampling)
# ---------------------------------------------------------------------------

class NeighborSampler:
    """Uniform fixed-fanout neighbor sampler over a CSR adjacency.

    Real sampling (numpy), deterministic given the step seed — the data
    pipeline contract required for fault-tolerant resume.  The reference's
    sampler, byte for byte.
    """

    def __init__(self, indptr: np.ndarray, indices: np.ndarray):
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.indices = np.asarray(indices, dtype=np.int32)

    @classmethod
    def from_edges(cls, n_nodes: int, src: np.ndarray, dst: np.ndarray):
        order = np.argsort(dst, kind="stable")
        src_sorted = src[order]
        counts = np.bincount(dst, minlength=n_nodes)
        indptr = np.zeros(n_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return cls(indptr, src_sorted)

    def sample(self, seeds: np.ndarray, fanouts: Tuple[int, ...],
               seed: int) -> Dict[str, np.ndarray]:
        """Returns hop-wise neighbor id matrices.

        out["hop0"] = seeds [B]; out[f"hop{i+1}"] = [B, f1*…*fi] node ids
        (self-padded where degree < fanout); hop1 keeps the frontier's
        [B, f1] shape, as the reference reshapes only later hops.
        """
        rng = np.random.default_rng(seed)
        out = {"hop0": seeds.astype(np.int32)}
        frontier = seeds
        width = 1
        for h, f in enumerate(fanouts):
            lo = self.indptr[frontier]
            hi = self.indptr[frontier + 1]
            deg = (hi - lo)
            # uniform with replacement; degree-0 nodes self-loop
            r = rng.random((len(frontier), f))
            pick = lo[:, None] + np.floor(r * np.maximum(deg, 1)[:, None]
                                          ).astype(np.int64)
            neigh = self.indices[np.minimum(pick, len(self.indices) - 1)]
            neigh = np.where(deg[:, None] > 0, neigh,
                             frontier[:, None].astype(np.int32))
            width *= f
            out[f"hop{h + 1}"] = neigh.reshape(len(seeds), width) \
                if h else neigh
            frontier = neigh.reshape(-1)
        return out


def gcn_sampled_loss(params: Dict, batch: Dict, cfg: GCNConfig):
    """2-hop sampled GCN step (fanouts f1, f2).

    batch: feats_hop0 [B,F], feats_hop1 [B,f1,F], feats_hop2 [B,f1,f2,F],
    labels [B].  Mean aggregation per hop (sampled-GCN estimator).
    """
    f0, f1, f2 = batch["feats_hop0"], batch["feats_hop1"], batch["feats_hop2"]
    w0, b0 = params["w0"], params["b0"]
    w1, b1 = params["w1"], params["b1"]
    # layer 1 applied at hop-1 nodes: agg over their sampled neighbors
    h1_in = f2 @ w0 + b0
    h1 = F.relu(f1 @ w0 + b0 + h1_in.mean(dim=2))
    # layer 2 at seeds: agg over hop-1
    h0_self = f0 @ w0 + b0
    h0 = F.relu(h0_self + (f1 @ w0 + b0).mean(dim=1))
    logits = h0 @ w1 + b1 + (h1 @ w1).mean(dim=1)
    return _nll(logits, batch["labels"]).mean()


# ---------------------------------------------------------------------------
# batched-small-graphs regime (molecules)
# ---------------------------------------------------------------------------

def gcn_molecule_loss(params: Dict, batch: Dict, cfg: GCNConfig):
    """batch: feats [G,N,F], src/dst [G,E], deg [G,N], labels [G]."""
    G, N, F_ = batch["feats"].shape
    # flatten graphs with node offsets so one scatter-add serves all
    offs = replicate_like(
        (torch.arange(G, device=batch["src"].device) * N)[:, None],
        batch["src"])
    src = (batch["src"].long() + offs).reshape(-1)
    dst = (batch["dst"].long() + offs).reshape(-1)
    x = batch["feats"].reshape(G * N, F_)
    deg = batch["deg"].reshape(G * N)
    for i in range(cfg.n_layers):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        x = _sym_norm_agg(x, src, dst, deg)
        if i < cfg.n_layers - 1:
            x = F.relu(x)
    pooled = x.reshape(G, N, -1).mean(dim=1)        # mean readout
    return _nll(pooled, batch["labels"]).mean()
