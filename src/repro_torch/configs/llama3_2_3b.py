"""Llama-3.2-3B: small llama3 dense GQA [hf:meta-llama/Llama-3.2-3B]."""
from .base import ModelConfig

FULL = ModelConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab=128256, rope_theta=5e5,
)


def smoke() -> ModelConfig:
    return FULL.replace(n_layers=2, d_model=48, n_heads=4, n_kv_heads=2,
                        d_ff=96, vocab=256, attn_block_q=16)
