from .kernel import flash_attention
from .ops import flash_attention_op
from .ref import attention_ref

__all__ = ["attention_ref", "flash_attention", "flash_attention_op"]
