"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-3b-a800m-base; hf].

32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40 experts
top-8.  NOTE: the assignment bracket text says "32 experts"; the primary
config string says 40e — we implement 40 (matches granite-3.0-3b-a800m;
32 belongs to 1b-a400m). head_dim = 1536/24 = 64.  The values of
``repro.configs.granite_moe_3b_a800m``.
"""
import torch

from ..models.lm import LMConfig
from .base import lm_arch

CONFIG = LMConfig(
    name="granite-moe-3b-a800m", n_layers=32, d_model=1536, n_heads=24,
    n_kv_heads=8, d_ff=512, vocab_size=49155, n_experts=40, top_k=8,
    dtype=torch.bfloat16)

ARCH = lm_arch("granite-moe-3b-a800m", CONFIG,
               source="hf:ibm-granite/granite-3.0-3b-a800m-base",
               notes="40 experts indivisible by 16-way model axis -> "
                     "experts pruned to FSDP, d_ff sharded instead")
