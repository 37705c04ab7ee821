from .ops import attention, attention_kernel
from .ref import attention_ref

__all__ = ["attention", "attention_kernel", "attention_ref"]
