"""dcn-v2 [arXiv:2008.13535; paper].

13 dense + 26 sparse, embed_dim=16, 3 full-matrix cross layers, deep MLP
1024-1024-512, cross interaction; Criteo-Kaggle vocabularies.  The
values of ``repro.configs.dcn_v2``.
"""
from ..models.recsys import CRITEO_VOCABS, RecsysConfig

CONFIG = RecsysConfig(
    name="dcn-v2", kind="dcn", embed_dim=16, n_dense=13,
    vocab_sizes=CRITEO_VOCABS, n_cross_layers=3, deep_mlp=(1024, 1024, 512))
