"""Qwen1.5-0.5B: dense with QKV bias [hf:Qwen/Qwen1.5-0.5B]."""
from .base import ModelConfig

FULL = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab=151936, qkv_bias=True,
)


def smoke() -> ModelConfig:
    return FULL.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                        d_ff=128, vocab=256, attn_block_q=16)
