"""gcn-cora [arXiv:1609.02907; paper].

2 layers, d_hidden=16, mean (symmetric-normalized) aggregation.
d_feat / n_classes vary per assigned shape (cora 1433/7; ogbn-products
100/47; reddit-minibatch 602/41; molecule 64/10).  The values of
``repro.configs.gcn_cora``.
"""
from ..models.gcn import GCNConfig

CONFIG = GCNConfig(name="gcn-cora", n_layers=2, d_hidden=16, n_classes=7,
                   d_feat=1433, aggregator="mean", fanouts=(15, 10))
