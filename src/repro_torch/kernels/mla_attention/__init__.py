from .ops import mla_decode, mla_decode_kernel, mla_prefill, mla_prefill_kernel
from .ref import mla_attention_ref, mla_decode_ref, mla_prefill_ref

__all__ = ["mla_decode", "mla_decode_kernel", "mla_prefill",
           "mla_prefill_kernel", "mla_attention_ref", "mla_decode_ref",
           "mla_prefill_ref"]
