from .ops import attention_bwd, attention_bwd_kernel

__all__ = ["attention_bwd", "attention_bwd_kernel"]
