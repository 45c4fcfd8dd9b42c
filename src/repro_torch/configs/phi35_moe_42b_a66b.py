"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16e top-2.
The values of ``repro.configs.phi35_moe_42b_a66b``.
"""
import torch

from ..models.lm import LMConfig
from .base import lm_arch

CONFIG = LMConfig(
    name="phi3.5-moe-42b-a6.6b", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, d_ff=6400, vocab_size=32064, n_experts=16, top_k=2,
    dtype=torch.bfloat16)

ARCH = lm_arch("phi3.5-moe-42b-a6.6b", CONFIG,
               source="hf:microsoft/Phi-3.5-MoE-instruct",
               notes="16 experts == 16-way model axis -> full EP")
