"""qwen3-14b [hf:Qwen/Qwen3-14B; hf].

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936, qk_norm,
head_dim=128.  The values of ``repro.configs.qwen3_14b``.
"""
import torch

from ..models.lm import LMConfig
from .base import lm_arch

CONFIG = LMConfig(
    name="qwen3-14b", n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
    d_head=128, d_ff=17408, vocab_size=151936, qk_norm=True,
    dtype=torch.bfloat16)

ARCH = lm_arch("qwen3-14b", CONFIG, source="hf:Qwen/Qwen3-14B",
               notes="40 heads indivisible by 16 -> attention weights "
                     "replicated over model axis; TP carried by d_ff/vocab")
