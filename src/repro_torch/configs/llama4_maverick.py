"""Llama-4-Maverick-400B-A17B: MoE 128e top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E]."""
from .base import ModelConfig

FULL = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048,
    n_experts=128, top_k=1,
)


def smoke() -> ModelConfig:
    return FULL.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        d_ff=128, vocab=256, n_experts=4, top_k=1,
                        attn_block_q=16)
