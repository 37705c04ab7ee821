from .ops import decode_attn, decode_kernel
from .ref import decode_attention_ref

__all__ = ["decode_attn", "decode_kernel", "decode_attention_ref"]
