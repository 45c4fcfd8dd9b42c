"""smollm-360m [hf:HuggingFaceTB/SmolLM-360M; hf].

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152 (llama-arch small).
head_dim = 960/15 = 64.  The values of ``repro.configs.smollm_360m``.
"""
import torch

from ..models.lm import LMConfig
from .base import lm_arch

CONFIG = LMConfig(
    name="smollm-360m", n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab_size=49152, dtype=torch.bfloat16)

ARCH = lm_arch("smollm-360m", CONFIG, source="hf:HuggingFaceTB/SmolLM-360M",
               notes="15 heads / d_model 960: indivisible by 16 -> heads & "
                     "d_model pruning exercises the fallback rules hardest")
