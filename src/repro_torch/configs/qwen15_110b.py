"""qwen1.5-110b [hf:Qwen/Qwen1.5-110B; hf].

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064, QKV bias.
The values of ``repro.configs.qwen15_110b``.
"""
import torch

from ..models.lm import LMConfig
from .base import lm_arch

CONFIG = LMConfig(
    name="qwen1.5-110b", n_layers=80, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=49152, vocab_size=152064, qkv_bias=True,
    dtype=torch.bfloat16)

ARCH = lm_arch("qwen1.5-110b", CONFIG, source="hf:Qwen/Qwen1.5-110B",
               notes="largest assigned arch (~111B params); memory posture "
                     "relies on FSDP(d_model->data) x TP(d_ff/heads->model)")
