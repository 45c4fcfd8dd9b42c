"""two-tower-retrieval [RecSys'19 (YouTube); unverified].

embed_dim=256, tower MLP 1024-512-256, dot interaction, sampled-softmax
retrieval; retrieval_cand scores 1 query against 1M candidates as one
batched matmul.  The values of ``repro.configs.two_tower_retrieval``.
"""
from ..models.recsys import RecsysConfig

CONFIG = RecsysConfig(
    name="two-tower-retrieval", kind="two_tower", embed_dim=256,
    tower_mlp=(1024, 512, 256), item_vocab=1_000_000, user_vocab=2_000_000)
