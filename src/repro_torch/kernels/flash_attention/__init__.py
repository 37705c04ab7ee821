from .ops import FlashAttention, attention, attention_kernel
from .ref import attention_bwd_ref, attention_lse_ref, attention_ref

__all__ = ["FlashAttention", "attention", "attention_bwd_ref",
           "attention_kernel", "attention_lse_ref", "attention_ref"]
