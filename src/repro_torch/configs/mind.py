"""mind [arXiv:1904.08030; unverified].

embed_dim=64, 4 interests, 3 capsule-routing iterations, multi-interest
interaction; item vocabulary 1M (paper uses industrial-scale billions).
The values of ``repro.configs.mind``.
"""
from ..models.recsys import RecsysConfig

CONFIG = RecsysConfig(
    name="mind", kind="mind", embed_dim=64, n_interests=4,
    capsule_iters=3, hist_len=50, item_vocab=1_000_000)
