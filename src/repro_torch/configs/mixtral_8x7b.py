"""Mixtral-8x7B: 8 experts top-2, sliding-window attention
[arXiv:2401.04088]."""
from .base import ModelConfig

FULL = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000,
    n_experts=8, top_k=2, sliding_window=4096,
)


def smoke() -> ModelConfig:
    return FULL.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        d_ff=128, vocab=256, n_experts=4, top_k=2,
                        sliding_window=32, attn_block_q=16)
