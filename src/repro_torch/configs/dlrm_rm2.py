"""dlrm-rm2 [arXiv:1906.00091; paper].

13 dense + 26 sparse features, embed_dim=64, bottom MLP 13-512-256-64,
top MLP 512-512-256-1, dot interaction.  Sparse vocabularies use the
public Criteo-Kaggle cardinalities.  The values of
``repro.configs.dlrm_rm2``.
"""
from ..models.recsys import CRITEO_VOCABS, RecsysConfig
from .base import recsys_arch

CONFIG = RecsysConfig(
    name="dlrm-rm2", kind="dlrm", embed_dim=64, n_dense=13,
    vocab_sizes=CRITEO_VOCABS, bot_mlp=(512, 256, 64),
    top_mlp=(512, 512, 256, 1))

ARCH = recsys_arch("dlrm-rm2", CONFIG, source="arXiv:1906.00091",
                   notes="embedding tables row-sharded over (data, model); "
                         "lookup = jnp.take + GSPMD gather collectives")
