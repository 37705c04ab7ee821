"""Jamba-1.5-Large-398B: Mamba+attention 1:7 interleave, MoE 16e top-2 on
every other layer [arXiv:2403.19887]."""
from .base import ModelConfig

FULL = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536,
    n_experts=16, top_k=2, moe_every=2, moe_offset=1,
    attn_every=8, attn_offset=4,
    d_state=16, d_conv=4, mamba_expand=2,
)


def smoke() -> ModelConfig:
    return FULL.replace(n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
                        d_ff=128, vocab=256, n_experts=4, top_k=2,
                        attn_every=4, attn_offset=2, moe_every=2,
                        moe_offset=1, attn_block_q=16)
